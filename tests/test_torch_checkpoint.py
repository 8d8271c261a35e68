"""`repro_torch.checkpoint`: the counterpart of every test in
``tests/test_checkpoint_manager.py`` (atomicity leftovers, bf16 round
trips through ``torch.bfloat16``, keep_n GC, integrity-failure fallback,
async-write error surfacing, with ``tests/faultinject.py``'s corruptors),
plus steps written by either package's manager and read by the other's,
with equal keys and arrays."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from faultinject import (
    corrupt_arrays,
    corrupt_manifest,
    half_delete,
    latest_step_dir,
    tear_arrays,
)
from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.checkpoint import read_atomic_dir as ref_read_atomic_dir
from repro_torch.checkpoint import (
    CheckpointManager,
    read_atomic_dir,
    write_atomic_dir,
)


def _state(step: int) -> dict:
    return {"w": np.arange(6, dtype=np.float32) + step, "b": np.int64(step)}


def test_leftover_tmp_dir_is_replaced_and_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    stale = tmp_path / "step_00000001.tmp"
    stale.mkdir()
    (stale / "arrays.npz").write_bytes(b"torn half-write")
    mgr.save(1, _state(1))
    assert mgr.all_steps() == [1]
    assert not stale.exists()  # the atomic rename consumed the retry's tmp
    step, st, _ = mgr.restore(_state(0))
    assert step == 1
    np.testing.assert_array_equal(st["w"], _state(1)["w"])


def test_bf16_roundtrip_exact(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    want = torch.tensor([1.5, -2.25, 3e-3, 65504.0], dtype=torch.bfloat16)
    mgr.save(1, {"x": want})
    _, st, _ = mgr.restore({"x": torch.zeros(4, dtype=torch.bfloat16)})
    assert st["x"].dtype == torch.bfloat16
    assert torch.equal(st["x"].view(torch.int16), want.view(torch.int16))
    assert "x::bf16" in read_atomic_dir(tmp_path / "step_00000001")[1]["keys"]


def test_keep_n_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_n=2, async_save=False)
    for s in range(1, 6):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [4, 5]
    assert mgr.latest_step() == 5


def test_all_steps_ignores_tmp_half_deleted_and_stray(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_n=0, async_save=False)
    for s in (1, 2, 3):
        mgr.save(s, _state(s))
    (tmp_path / "step_00000009.tmp").mkdir()
    (tmp_path / "step_bogus").mkdir()
    half_delete(tmp_path / "step_00000002")  # arrays.npz gone, dir remains
    assert mgr.all_steps() == [1, 3]


@pytest.mark.parametrize(
    "damage", [tear_arrays, corrupt_arrays, corrupt_manifest, half_delete]
)
def test_restore_falls_back_to_newest_intact_step(tmp_path, damage):
    mgr = CheckpointManager(tmp_path, keep_n=0, async_save=False)
    for s in (1, 2, 3):
        mgr.save(s, _state(s))
    damage(latest_step_dir(tmp_path))
    step, st, _ = mgr.restore(_state(0))  # step=None -> latest valid
    assert step == 2
    np.testing.assert_array_equal(st["w"], _state(2)["w"])


def test_restore_latest_valid_flat_mode(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, _state(1), extra={"kind": "test"})
    mgr.save(2, _state(2), extra={"kind": "test2"})
    corrupt_manifest(latest_step_dir(tmp_path))
    step, flat, extra = mgr.restore_latest_valid()  # like=None: raw dict
    assert step == 1 and extra == {"kind": "test"}
    np.testing.assert_array_equal(flat["w"], _state(1)["w"])


def test_every_step_damaged_raises_ioerror(tmp_path):
    mgr = CheckpointManager(tmp_path, keep_n=0, async_save=False)
    mgr.save(1, _state(1))
    mgr.save(2, _state(2))
    corrupt_arrays(tmp_path / "step_00000001")
    tear_arrays(tmp_path / "step_00000002")
    with pytest.raises(IOError):
        mgr.restore(_state(0))


def test_no_steps_raises_filenotfound(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_state(0))


def test_explicit_step_still_raises_on_corruption(tmp_path):
    # callers pinning a step opt out of the fallback: corruption must raise
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, _state(1))
    corrupt_arrays(tmp_path / "step_00000001")
    with pytest.raises(IOError):
        mgr.restore(_state(0), step=1)


def test_async_write_failure_surfaces_on_next_save(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_save=True)
    blocker = tmp_path / "blocker"
    blocker.write_text("a file where the checkpoint dir should be")
    mgr.dir = blocker / "sub"  # forces the background _write to fail
    mgr.save(1, _state(1))  # enqueues; the failure lands in the background
    with pytest.raises(OSError):
        mgr.save(2, _state(2))  # surfaces the previous write's exception
    mgr.dir = tmp_path / "ck"  # healthy again: save 2 was re-raised, not kept
    mgr.save(3, _state(3))
    mgr.wait()
    assert mgr.all_steps() == [3]


def test_wait_reraises_background_failure_once(tmp_path):
    mgr = CheckpointManager(tmp_path / "ck", async_save=True)
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    mgr.dir = blocker / "sub"
    mgr.save(1, _state(1))
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # the error was consumed; a second wait is clean


# ------------------------------------------------------ the port's own trees
def test_nested_tree_of_tensors_restores_on_device(tmp_path):
    """Dict keys sorted, sequences indexed, ``None`` an empty subtree,
    torch tensors and numpy arrays as leaves; ``device=`` places every leaf
    as a tensor there; a shape mismatch skips the step."""
    mgr = CheckpointManager(tmp_path, keep_n=0, async_save=False)
    tree = {"z": [torch.arange(3), (np.ones((2, 2)), None)], "a": {"s": np.float64(2.5)}}
    mgr.save(1, tree, extra={"n": 1})
    flat, manifest = read_atomic_dir(tmp_path / "step_00000001")
    assert manifest["keys"] == ["a/s", "z/0", "z/1/0"]
    like = {"z": [torch.zeros(3, dtype=torch.int64), (np.zeros((2, 2)), None)],
            "a": {"s": np.float64(0)}}
    step, st, extra = mgr.restore(like, device="cpu")
    assert step == 1 and extra == {"n": 1}
    assert isinstance(st["z"][1], tuple) and st["z"][1][1] is None
    assert torch.equal(st["z"][0], torch.arange(3))
    assert torch.equal(st["z"][1][0], torch.ones((2, 2), dtype=torch.float64))
    assert st["a"]["s"].item() == 2.5
    mgr.save(2, {"z": [torch.arange(4), (np.ones((2, 2)), None)], "a": {"s": 1.0}})
    assert mgr.restore(like)[0] == 1  # step 2's (4,) leaf does not fit: skipped


# ----------------------------------------------------- across the two packages
def _mixed_state(step: int) -> dict:
    return {"w": np.arange(6, dtype=np.float32) + step, "b": np.int64(step),
            "layers": [np.full((2, 3), step, dtype=np.int32), {"k": np.ones(2)}]}


def _equal_flat(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w)


def test_reference_step_reads_in_port(tmp_path):
    RefCheckpointManager(tmp_path, async_save=False).save(
        3, dict(_mixed_state(3), h=jnp.asarray([1.5, -2.0], dtype=jnp.bfloat16)),
        extra={"kind": "ref"})
    want, wman = ref_read_atomic_dir(tmp_path / "step_00000003")
    got, man = read_atomic_dir(tmp_path / "step_00000003")
    assert man == wman and man["extra"] == {"kind": "ref"}
    assert got["h"].dtype == torch.bfloat16
    assert torch.equal(got.pop("h").view(torch.int16),
                       torch.from_numpy(np.asarray(want.pop("h")).view(np.int16)))
    _equal_flat(got, want)
    mgr = CheckpointManager(tmp_path, async_save=False)
    step, st, extra = mgr.restore(_mixed_state(0))
    assert step == 3 and extra == {"kind": "ref"}
    _equal_flat({"w": st["w"], "b": st["b"], "l0": st["layers"][0],
                 "k": st["layers"][1]["k"]},
                {"w": want["w"], "b": want["b"], "l0": want["layers/0"],
                 "k": want["layers/1/k"]})


def test_port_step_reads_in_reference(tmp_path):
    CheckpointManager(tmp_path, async_save=False).save(
        4, dict(_mixed_state(4), h=torch.tensor([1.5, -2.0], dtype=torch.bfloat16)),
        extra={"kind": "port"})
    want, wman = read_atomic_dir(tmp_path / "step_00000004")
    got, man = ref_read_atomic_dir(tmp_path / "step_00000004")
    assert man == wman and man["extra"] == {"kind": "port"}
    assert got["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(got.pop("h")).view(np.int16),
                                  want.pop("h").view(torch.int16).numpy())
    _equal_flat(got, want)
    step, st, extra = RefCheckpointManager(tmp_path, async_save=False).restore(
        _mixed_state(0))
    assert step == 4 and extra == {"kind": "port"}
    np.testing.assert_array_equal(st["layers"][0], _mixed_state(4)["layers"][0])


def test_write_atomic_dir_replaces_an_existing_entry(tmp_path):
    write_atomic_dir(tmp_path / "e", {"a": np.arange(3)}, {"n": 1})
    write_atomic_dir(tmp_path / "e", {"a": np.arange(4)}, {"n": 2})
    got, man = read_atomic_dir(tmp_path / "e")
    assert man["n"] == 2
    np.testing.assert_array_equal(got["a"], np.arange(4))
    assert [p.name for p in tmp_path.iterdir()] == ["e"]  # no stray tmp left


# ------------------------------------------------ NamedTuple trees (TrainState)
def _train_state_arrays(seed: int) -> tuple[dict, dict]:
    """A parameter tree with float32 and bf16 leaves, and its AdamW state
    (float32 moments, int32 step), as numpy arrays (bf16 as uint16 bits)."""
    rng = np.random.default_rng(seed)
    params = {"embed": rng.normal(size=(5, 3)).astype(np.float32),
              "layers": {"w": rng.normal(size=(2, 3, 3)).astype(np.float32),
                         "n": rng.normal(size=(2, 3)).astype(np.float32)}}
    bf16_bits = (rng.integers(0, 2**16, size=(4,)) & 0x7F7F).astype(np.uint16)
    opt = {"m": {k: v for k, v in params.items()},
           "v": {k: v for k, v in params.items()},
           "step": np.asarray(seed, np.int32)}
    return params, opt, bf16_bits


def _ref_train_state(seed: int):
    from repro.runtime import TrainState as RefTrainState

    params, opt, bits = _train_state_arrays(seed)
    params = dict(params, h=jnp.asarray(bits.view(jnp.bfloat16)))
    return RefTrainState(params, opt)


def _port_train_state(seed: int):
    from repro_torch.runtime import TrainState

    params, opt, bits = _train_state_arrays(seed)
    tree = lambda t: {k: tree(v) if isinstance(v, dict) else torch.from_numpy(np.asarray(v))  # noqa: E731
                      for k, v in t.items()}
    params = dict(tree(params), h=torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))
    return TrainState(params, tree(opt))


TRAIN_STATE_KEYS = [".opt/m/embed", ".opt/m/layers/n", ".opt/m/layers/w", ".opt/step",
                    ".opt/v/embed", ".opt/v/layers/n", ".opt/v/layers/w",
                    ".params/embed", ".params/h::bf16", ".params/layers/n",
                    ".params/layers/w"]


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    return np.asarray(x).reshape(-1).view(np.uint8)


def _assert_bit_equal(got_state, want_state) -> None:
    got = dict(_flat_items(got_state))
    want = dict(_flat_items(want_state))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)


def _flat_items(state, prefix=""):
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        for f in state._fields:
            yield from _flat_items(getattr(state, f), f"{prefix}.{f}/")
    elif isinstance(state, dict):
        for k in sorted(state):
            yield from _flat_items(state[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), state


def test_train_state_keys_are_the_references(tmp_path):
    """A `TrainState` flattens to JAX's attribute keys, ``.params/...`` and
    ``.opt/...``, in both packages; plain tuples keep their index keys."""
    RefCheckpointManager(tmp_path / "ref", async_save=False).save(1, _ref_train_state(1))
    CheckpointManager(tmp_path / "port", async_save=False).save(1, _port_train_state(1))
    for d in ("ref", "port"):
        _, man = read_atomic_dir(tmp_path / d / "step_00000001")
        assert man["keys"] == TRAIN_STATE_KEYS, d
    CheckpointManager(tmp_path / "tuple", async_save=False).save(
        1, (np.ones(2), [np.zeros(1)]))
    assert read_atomic_dir(tmp_path / "tuple" / "step_00000001")[1]["keys"] == ["0", "1/0"]


def test_reference_train_state_restores_in_port(tmp_path):
    from repro_torch.runtime import TrainState

    want = _ref_train_state(7)
    RefCheckpointManager(tmp_path, async_save=False).save(7, want, extra={"data": {"step": 7}})
    step, got, extra = CheckpointManager(tmp_path, async_save=False).restore(
        _port_train_state(0), device="cpu")
    assert step == 7 and extra == {"data": {"step": 7}}
    assert type(got) is TrainState
    assert got.params["h"].dtype == torch.bfloat16 and got.opt["step"].dtype == torch.int32
    _assert_bit_equal(got, want)


def test_port_train_state_restores_in_reference(tmp_path):
    from repro.runtime import TrainState as RefTrainState

    want = _port_train_state(9)
    CheckpointManager(tmp_path, async_save=False).save(9, want, extra={"data": {"step": 9}})
    like = _ref_train_state(0)
    step, got, extra = RefCheckpointManager(tmp_path, async_save=False).restore(like)
    assert step == 9 and extra == {"data": {"step": 9}}
    assert type(got) is RefTrainState
    assert got.params["h"].dtype == jnp.bfloat16
    _assert_bit_equal(got, want)
