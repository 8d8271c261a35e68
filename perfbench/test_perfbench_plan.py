"""The plan cell (``granite4h.plan-sa``) on the CPU: its configuration's
rows are the planner's problem, a shrunk run is correct and reports its
metrics, a store altered after the clock or a decode off the reference
makes it not correct through ``missing``, and the benchmark's plain
reference is the port's."""
import json
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench import bench, decode_check
from perfbench import plain_granite4h as bench_plain
from perfbench.drivers import plan

ROOT = Path(__file__).resolve().parents[1]
CELL = "granite4h.plan-sa"
CONFIG = json.loads((ROOT / "perfbench" / "configs" / "granite-4.0-h-small.ep8.json").read_text())


def shrink(traffic):
    t = json.loads(json.dumps(traffic))
    t["settings"]["max_iterations"] = 40
    t["decode"] = dict(batch=2, prompt_len=40, steps=4)
    return t


def run(seed=2**31 + 17, trace=False):
    return bench.run_cell(CELL, seed, 0.3, trace, "cpu", time.perf_counter(),
                          traffic_override=shrink, log=lambda m: None)


def test_the_rows_are_the_tools_from_the_meta_tree():
    sys.path.insert(0, str(ROOT / "tools"))
    import granite4h_plan_rows as tool

    model = CONFIG["model"]
    assert CONFIG["accelerators"][model["rows"]] == tool.plan_rows()
    assert CONFIG["accelerators"][model["smoke_rows"]] == tool.plan_rows(smoke=True)
    assert len(CONFIG["accelerators"][model["rows"]]) == 481


def test_the_file_holds_the_ports_config_and_its_cut():
    from repro_torch.configs import get_config, get_smoke_config

    keys, start = plan.published(get_config(CONFIG["model"]["arch"]))
    assert {k: CONFIG[k] for k in keys} == keys and start == CONFIG["model"]["held"]["expert_start"]
    smoke, _ = plan.published(get_smoke_config(CONFIG["model"]["arch"]))
    assert dict(smoke, expert_start=0) == CONFIG["model"]["smoke"]
    assert CONFIG["num_local_experts"] == 72 and CONFIG["n_experts"] == 9
    assert set(bench.load_manifest()["configs"][-1]["reduced"]) == {"n_experts", "vocab_size"}


@pytest.mark.parametrize("trace", [False, True])
def test_a_shrunk_run_is_correct_and_reports_its_metrics(trace):
    r = run(trace=trace)
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    want = ({"plan_prep_ms_per_plan", "plan_banks_ms_per_plan", "store_ms_per_plan"} if trace
            else {"setup_s", "pack_s"})
    assert want <= set(r["metrics"])


def test_an_altered_bank_byte_is_missing(monkeypatch):
    orig = plan.PlanDriver._verify_store
    altered = []

    def alter_then_verify(self, st):
        if not altered:  # one bank byte of the window's first store
            bank = next(iter(st.banks.values()))
            bank.view(torch.int16)[0, 0] ^= 1
            altered.append(st)
        return orig(self, st)
    monkeypatch.setattr(plan.PlanDriver, "_verify_store", alter_then_verify)
    r = run()
    assert r["correct"] is False and r["checks"]["missing"]["value"] >= 1
    assert r["checks"]["invalid"]["value"] == r["checks"]["mismatched"]["value"] == 0


def test_a_bf16_decode_state_is_missing(monkeypatch):
    """The control of the decode check: each Mamba layer's decode state in
    bfloat16, the precision below the configuration's float32 state."""
    from repro_torch.models import blocks

    orig = blocks.ssm_decode

    def bf16_state(cfg, params, x_in, cache, compute_dtype):
        c = dict(cache, state=cache["state"].to(torch.bfloat16).float())
        out, new = orig(cfg, params, x_in, c, compute_dtype)
        return out, dict(new, state=new["state"].to(torch.bfloat16).float())
    monkeypatch.setattr(blocks, "ssm_decode", bf16_state)
    r = run()
    assert r["correct"] is False and r["checks"]["missing"]["value"] == 1


def test_the_decode_check_is_within_its_limits_and_masks_near_ties():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M

    cfg = get_smoke_config("granite-4.0-h-small")
    out = decode_check.run(cfg, cfg.plain_keys(), M.init_params(cfg, 4, device="cpu"), 2, 48,
                           3, 2**35 + 1, torch.device("cpu"))
    assert not decode_check.failed(out) and out["tokens"] == 2 * 51 and out["dropped"] == 0
    assert decode_check.failed(dict(out, dropped=1)) == ["moe.dropped"]
    logits = torch.tensor([[5.0, 4.0, 3.0, 2.9995, 1.0], [5.0, 4.0, 3.0, 2.0, 1.0],
                           [5.0, 4.0, 3.0, 2.9995, 1.0]])
    # top-3 boundary between experts 2 and 3: a near-tie in rows 0 and 2,
    # which matters where either is held
    assert decode_check.ambiguous(logits, 3, 3, 2, 1e-3).tolist() == [True, False, True]
    assert decode_check.ambiguous(logits, 3, 0, 2, 1e-3).tolist() == [False, False, False]


def test_the_benchmarks_plain_reference_is_the_ports():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.models import plain_granite4h as port_plain

    cfg = get_smoke_config("granite-4.0-h-small")
    params = M.init_params(cfg, 6, device="cpu")
    tok = torch.randint(2, cfg.vocab_size, (2, 21), generator=torch.Generator().manual_seed(6))
    a = bench_plain.forward(cfg.plain_keys(), params, tok, keep_inputs=True)
    b = port_plain.forward(cfg.plain_keys(), params, tok, keep_inputs=True)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(a[1] + a[2], b[1] + b[2]))
    names = {n for n in sys.modules if n.split(".")[0] == "repro_torch"}
    src = (ROOT / "perfbench" / "plain_granite4h.py").read_text()
    assert "repro_torch" not in src and "import jax" not in src and names
