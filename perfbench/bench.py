"""One run of one cell: set up, measure, check, report.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names the
cell's configuration file and traffic mix, the traffic mix is
``perfbench/traffic/<traffic>.json``, its ``entry`` is driven by
``perfbench/drivers/<entry>.py``, and each metric is read by
``perfbench/metrics/<metric>.py`` (``read(run) -> number or None``; a
per-layer reader also names the host spans it needs, ``SPANS`` and
``NOTES``, see `spans.py`).  A cell, a configuration, a traffic mix, an
entry or a metric is added by adding files and manifest entries, never by
editing this module.

A traced run (``--trace 1``) measures in two parts of half the window
each: first with the host spans alone, which the host-span metrics read,
then with the device trace too, which the device metrics read.  The
profiler costs the host time on every copy and launch, so no host reading
is taken under it.
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

from . import check, drivers

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_parts(manifest: dict, workload: str, root: Path = ROOT):
    """``(cell, config, traffic)`` for a cell name; KeyError if unknown."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def applies(metric: dict, workload: str) -> bool:
    """A metric with ``workloads`` is reported in those cells, one without
    it in every cell (every per-layer metric lists its cells)."""
    return workload in metric.get("workloads", (workload,))


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's (whole names: ``repro_torch`` is not
    ``repro``)."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Run:
    """What the metric readers read: the driver's counts (``rec``), the
    host spans (``spans``, without the profiler), the notes kept beside the
    traced calls and the device trace, and the device's name."""

    def __init__(self, rec, spans=None, notes=None, trace=None, device_name=None, setup_s=None):
        self.rec, self.trace, self.device_name, self.setup_s = rec, trace, device_name, setup_s
        self.spans, self.notes = spans or {}, notes or {}

    def seconds(self, label) -> float:
        return sum(d for _, d, _ in self.spans.get(label, ()))

    def count(self, label) -> int:
        return len(self.spans.get(label, ()))


def _log_window(rec: dict, log, part: str) -> None:
    if rec.get("each_s"):
        e = rec["each_s"]
        log(f"[window{part}] {len(e)} calls in {rec['window_s']:.3f} s, seconds first {e[0]:.4f}, "
            f"min {min(e):.4f}, median {sorted(e)[len(e) // 2]:.4f}, max {max(e):.4f}")
    if rec.get("latencies_s"):
        from .stats import nearest_rank

        lat = [x for x in rec["latencies_s"] if x is not None]
        if lat:
            log(f"[latency{part}] answered {len(lat)}, mean {sum(lat) / len(lat) * 1e3:.1f} ms, "
                + ", ".join(f"p{round(q * 100)} {nearest_rank(lat, q) * 1e3:.1f}"
                            for q in (0.5, 0.9, 0.95, 0.99, 1.0)))
    if rec.get("lateness_s"):
        late = rec["lateness_s"]
        log(f"[generator{part}] requests {len(late)}, lateness max {max(late):.6f} s, "
            f"mean {sum(late) / len(late):.6f} s")


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, manifest: dict | None = None, traffic_override=None,
             log=print) -> dict:
    """One run; returns the result line's object.  ``traffic_override``
    (a function of the traffic dict) lets a test shrink a cell to run on the
    CPU."""
    import torch

    from .spans import Spans
    from .trace import DeviceTrace

    manifest = manifest or load_manifest()
    cell, config, traffic = cell_parts(manifest, workload)
    if traffic_override is not None:
        traffic = traffic_override(traffic)
    check.replay_ready(traffic)
    e2e = [m for m in manifest["end_to_end"] if applies(m, workload)]
    layer = [m for m in manifest["per_layer"] if applies(m, workload)]
    metrics = layer if trace else e2e
    readers = {m["name"]: reader(m["name"]) for m in metrics}

    on_card = torch.device(device).type == "cuda"
    driver = drivers.load(traffic["entry"])(config, traffic, seed, device)
    driver.setup()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    targets, note_fns = {}, {}
    for r in readers.values():
        targets.update(getattr(r, "SPANS", {}))
        note_fns.update(getattr(r, "NOTES", {}))
    device_name = torch.cuda.get_device_name(0) if on_card else "cpu"
    dtrace = None
    if not trace:
        recs = [driver.window(seconds)]
        if on_card:
            torch.cuda.synchronize()
        run = Run(recs[0], device_name=device_name, setup_s=setup_s)
    else:
        # part 1: host spans only; part 2: spans (which name the idle gaps),
        # the notes of the traced calls, and the profiler
        with Spans(targets) as host:
            recs = [driver.window(seconds / 2)]
        if on_card:
            torch.cuda.synchronize()
        dtrace = DeviceTrace() if on_card else None
        with Spans(targets, note_fns) as traced, (dtrace or contextlib.nullcontext()):
            recs.append(driver.window(seconds - seconds / 2))
        run = Run(recs[0], host.spans, traced.notes, dtrace, device_name, setup_s)
        under = Run(recs[1], traced.spans, traced.notes, dtrace, device_name, setup_s)

    device = dict(platform="gpu" if on_card else "cpu", kind=device_name,
                  count=1 if on_card else 0,
                  memory_peak_bytes=int(torch.cuda.max_memory_allocated(0)) if on_card else 0)
    out_metrics = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            out_metrics[m["name"]] = dict(value=v, unit=m["unit"])
        if trace and m["source"] != "device_trace" and getattr(readers[m["name"]], "SPANS", None):
            log(f"[spans] {m['name']} {v} without the profiler, "
                f"{readers[m['name']].read(under)} under it")
    attempted = sum(r["attempted"] for r in recs)
    failed = sum(r["failed"] for r in recs)
    result = dict(correct=None, attempted=attempted, failed=failed,
                  metrics=out_metrics, device=device)
    if dtrace is not None:
        device.update(busy_s=dtrace.busy_s(), window_s=dtrace.window_s)
        result["breakdown"] = dict(device_ops=dtrace.top_ops(),
                                   idle_gaps=dtrace.idle_gaps(traced.spans))
    for i, r in enumerate(recs):
        _log_window(r, log, "" if len(recs) == 1 else f" part {i + 1}")

    # the program's state goes before the reference runs, so the peak above
    # is the program's alone
    solves, missing = driver.solves, sum(r.get("missing", 0) for r in recs)
    del driver, run, dtrace
    if trace:
        del under
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = check.check(config, traffic, solves, seed, missing=missing)
    for note in verdict["notes"][:20]:
        log(f"[check] {note}")
    log(f"[check] judged {verdict['judged']}, replayed {verdict['replayed']} in "
        f"{verdict['replay_s']:.3f} s")
    result["correct"] = check.passed(verdict["values"])
    result["checks"] = {k: dict(value=v, limit=check.LIMITS[k])
                        for k, v in verdict["values"].items()}
    return result
