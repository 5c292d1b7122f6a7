"""The benchmark of ``bp_from_video_tpu_torch`` on one NVIDIA card.

    python3 -m gpubench --workload CELL --seed N --seconds S --trace 0|1

Reads ``BENCHMARK.json`` in the working directory, finds the cell, its
configuration file (the entry's ``file``), the system that file names
(``gpubench/systems/<system>``: what is built, driven, judged and counted)
and its traffic mix (``gpubench/traffic/<traffic>.json``), builds the port
and its inputs from the seed on the card, warms up every shape the mix
uses, then calls the port back to back for ``--seconds`` (``window``).
With ``--trace 0`` the last line of standard output holds the cell's
end-to-end metrics; with ``--trace 1`` the run then profiles a fixed slice
of calls and reports the per-layer metrics, each read by
``metrics/<name>.py``.  Either way the reference then judges the calls
the window kept and runs the first calls of the run by itself (the
system's ``judge`` and ``judge_own``), and the numbers it compared go to
standard error, each beside its limit, and into the result line under
``checks``.

Exits 3 without a CUDA card (or with fewer than the cell asks for), 4
when JAX, its libraries or the JAX package are loaded, 2 when the cell or
its files are missing.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import json
import os
import subprocess
import sys
import time

_T_IMPORT = time.perf_counter()

from gpubench import guard  # noqa: E402

# Set-up marks of this process (seconds), logged with the run.
MARKS: dict[str, float] = {}


def log(*a) -> None:
    print(*a, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (``/proc``; the import time of
    this module where ``/proc`` is absent)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


# -- the benchmark's files ----------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    spec: dict            # the configuration file
    traffic: object       # traffic.Traffic
    end_to_end: list
    per_layer: list
    system: object        # the module under gpubench.systems the file names


def load_cell(root: str, name: str, overrides: dict | None = None) -> Cell:
    import gpubench.systems as systems
    from gpubench import traffic as traffic_mod
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise LookupError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(os.path.join(root, conf["file"])) as f:
        spec = json.load(f)
    with open(os.path.join(root, "gpubench", "traffic",
                           wl["traffic"] + ".json")) as f:
        tdict = json.load(f)
    overrides = overrides or {}
    spec = dict(spec, engine=dict(spec["engine"],
                                  **overrides.get("engine", {})))
    tdict.update(overrides.get("traffic", {}))
    system = systems.load(spec)
    t = traffic_mod.Traffic.from_dict(wl["traffic"], tdict,
                                      system.TRAFFIC_KEYS)

    def mine(m):
        return name in m.get("workloads", [name])
    return Cell(name, wl, spec, t,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)], system)


def numbers_for(cell: Cell) -> dict:
    """The cell's compared numbers and their limits."""
    return cell.system.limits(cell.spec, cell.traffic)


# -- card facts -----------------------------------------------------------------


def smi(query: str) -> str:
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


# -- one run ------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    """What the per-layer readers read."""

    cell: Cell
    window: object
    trace: object = None
    syncs_per_call: float | None = None
    flops_per_call: float | None = None
    kernel_bounds: dict = dataclasses.field(default_factory=dict)


def execute(root: str, name: str, seed: int, seconds: float, trace: bool,
            device: str = "cuda", overrides: dict | None = None,
            control: bool = False) -> dict:
    """One run of cell ``name``; returns everything the result line and
    the logs need (``control``: also the control's readings)."""
    import torch

    cell = load_cell(root, name, overrides)
    dev = torch.device(device)
    workdir = os.path.join(root, ".gpubench")
    os.makedirs(workdir, exist_ok=True)
    a = time.perf_counter()
    inputs = cell.system.make_inputs(cell.spec, cell.traffic, seed, workdir)
    MARKS["inputs from the seed"] = time.perf_counter() - a
    try:
        return _execute(cell, seed, seconds, trace, dev, inputs, control,
                        workdir)
    finally:
        inputs.close()


def _execute(cell, seed, seconds, trace, dev, inputs, control, workdir):
    import torch

    from gpubench import check, trace as trace_mod
    from gpubench import traffic as traffic_mod
    from gpubench import window as window_mod
    sysm, t = cell.system, cell.traffic
    e = cell.spec["engine"]
    s, h, w = e["streams"], e["height"], e["width"]
    cuda = dev.type == "cuda"
    phases = dict(MARKS, **{"process start to build": process_age_s()})
    a = time.perf_counter()
    port, cfg = sysm.build_port(cell.spec, inputs, dev)
    phases["port build"] = time.perf_counter() - a
    a = time.perf_counter()
    clip = traffic_mod.pulse_clip(t, s, h, w, seed, dev)
    if cuda:
        torch.cuda.synchronize()
    phases["clip"] = time.perf_counter() - a
    drv = window_mod.Driver(sysm, port, t, clip,
                            window_mod.timestamp_table(t, s, dev),
                            own_call=t.own_calls - 1)
    state0 = sysm.start_state(port, cfg, t, dev)
    state = state0
    # Warm-up: the same calls the window makes (every shape it uses),
    # holding as many calls' results as the check will hold, so that the
    # allocator has cached their blocks before the window.
    tw, held = [], []
    a0 = time.perf_counter()
    for call in range(t.warmup_calls):
        a = time.perf_counter()
        before = state
        state, out_w, _ = drv.call(state, call)
        tw.append(time.perf_counter() - a)
        held = (held + [(before, out_w, state)])[-(t.check_calls + 2):]
    del held, out_w, before
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    phases["warm-up"] = time.perf_counter() - a0
    setup_s = process_age_s()
    rate = 1.0 / max(sorted(tw)[len(tw) // 2], 1e-6)
    check_at = window_mod.check_calls(seed, rate * seconds * 0.9,
                                      t.check_calls)
    k0 = sysm.launch_counts()
    clocks_before = smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")
    res = window_mod.run_window(drv, state, t.warmup_calls, seconds,
                                check_at)
    clocks_after = smi("clocks.sm,clocks.mem,power.draw,temperature.gpu")
    k1 = sysm.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    done = res.calls - res.failed_calls
    per_call = {k: (k1[k] - k0[k]) / max(done, 1) for k in k1}
    out = dict(cell=cell, setup_s=setup_s, window=res, peak=peak,
               phases=phases, warm_calls_s=tw,
               launches_per_call=per_call, clocks=(clocks_before,
                                                    clocks_after),
               tracked_end=sysm.tracked(res.state),
               tracked_start=sysm.tracked(state0))
    run = Run(cell, res)
    state, nxt = res.state, res.next_call
    # A window too short to reach the call the reference's own run ends
    # on goes on, untimed, until it does.
    while drv.own is None:
        state, _, _ = drv.call(state, nxt)
        nxt += 1
    if trace:
        run.trace, state, nxt = trace_mod.profile_calls(
            drv, state, nxt, t.profile_calls,
            os.path.join(workdir, "trace.json"))

        def syncs():
            st = state
            for c in range(nxt, nxt + t.sync_calls):
                st, _, _ = drv.call(st, c)
        run.syncs_per_call = trace_mod.count_syncs(syncs) / t.sync_calls
    # The port's state is freed before the reference runs; the checked
    # calls and the own run's end keep what they need.
    checked, own, inputs_of = res.checked, drv.own, drv.inputs
    init_port = state0
    del port, state, res.state
    drv.port = None
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = sysm.build_reference(cell.spec, inputs, dev)
    numbers = numbers_for(cell)
    readings = [sysm.judge(ref, c) for c in checked]
    start_ref = sysm.ref_start_state(ref, cfg, t, dev)
    start_ok = sysm.same_start(start_ref, init_port)

    def ref_step(st, frames, ts):
        return sysm.ref_step(ref, st, frames, ts)
    own_ref = check.own_run(ref_step, start_ref, inputs_of, t.own_calls)
    readings.append(sysm.judge_own(cfg, *own_ref, *own))
    worst = check.worst(readings)
    ok, lines = check.verdict(worst, numbers)
    if not start_ok:
        ok = False
        lines.append("start_state differs from the reference's")
    out.update(correct=ok, check_lines=lines, worst=worst, limits=numbers,
               checked_calls=[c.call for c in checked],
               check_s=time.perf_counter() - t_ref)
    if trace:
        from gpubench import counts
        run.flops_per_call = sysm.net_flops(ref, cell.spec, t, cfg)
        for kernel, launches in cell.spec.get("kernels", {}).items():
            run.kernel_bounds[kernel] = counts.kernel_bound_s(
                sysm.KERNELS[kernel], launches,
                lambda net: sysm.batch_of(net, cfg, t))
        vals = {}
        for m in cell.per_layer:
            mod = importlib.import_module(f"gpubench.metrics.{m['name']}")
            v = mod.read(run)
            if v is not None:
                vals[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out.update(per_layer=vals, trace=run.trace)
    if control:
        out.update(_control_readings(cell, cfg, inputs, dev, ref, checked,
                                     start_ref, inputs_of, own_ref))
    return out


def _control_readings(cell, cfg, inputs, dev, ref, checked, start_ref,
                      inputs_of, own_ref) -> dict:
    """The control's readings on the same checked calls and own run
    (``control_worst``), and those of the fault the system plants in the
    port's checked calls, where it has one (``fault_worst``)."""
    import torch

    from gpubench import check
    sysm = cell.system
    ctl = sysm.control(cell.spec, inputs, dev)
    ctl_readings = []
    for c in checked:
        with torch.no_grad():
            st1, o1 = ctl.step(c.state_in, c.frames, c.ts)
        ctl_readings.append(sysm.judge(ref, dataclasses.replace(
            c, out=o1, state_out=st1)))
    own_ctl = check.own_run(ctl.step, start_ref, inputs_of,
                            cell.traffic.own_calls)
    ctl_readings.append(sysm.judge_own(cfg, *own_ref, *own_ctl))
    got = {"control_worst": check.worst(ctl_readings)}
    fault = sysm.faults(ref, checked, cell.traffic)
    if fault is not None:
        got["fault_worst"] = fault
    return got


# -- the command ----------------------------------------------------------------


def result_line(r: dict, trace: bool, device_info: dict) -> dict:
    cell = r["cell"]
    t = cell.traffic
    s = cell.spec["engine"]["streams"]
    res = r["window"]
    per = s * t.frames_per_call
    if trace:
        metrics = r["per_layer"]
        tr = r["trace"]
        device_info = dict(device_info, busy_s=tr.busy_s,
                           window_s=tr.window_s)
    else:
        from gpubench import window as window_mod
        done = res.calls - res.failed_calls
        vals = {"frames_per_s": done * per / res.window_s,
                "step_ms_p95": 1e3 * window_mod.p95(res.step_s),
                "setup_s": r["setup_s"]}
        metrics = {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line = {"correct": bool(r["correct"]), "attempted": res.calls * per,
            "failed": res.failed_calls * per, "metrics": metrics,
            "device": dict(device_info, memory_peak_bytes=r["peak"])}
    if trace:
        tr = r["trace"]
        top = sorted(tr.by_name.items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[n[:200], v] for n, v in top],
                             "idle_gaps": [[n[:200], v]
                                           for n, v in tr.idle_gaps]}
    line["checks"] = {k: {"value": r["worst"].get(k), "limit": v}
                      for k, v in r["limits"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gpubench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    MARKS["python and the harness's imports"] = process_age_s()
    root = os.getcwd()
    build = os.path.join(root, ".gpubench", "cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    a = time.perf_counter()
    try:
        guard.check("start")
        cell = load_cell(root, args.workload)
    except ImportError as e:
        print(e, file=sys.stderr)
        return 4
    except (OSError, LookupError, KeyError, ValueError) as e:
        print(f"gpubench: {e}", file=sys.stderr)
        return 2
    MARKS["the cell, torch and the system's modules"] = (
        time.perf_counter() - a)
    import torch
    torch.set_num_threads(1)
    need = int(cell.workload.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"gpubench: needs {need} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, "
              f"count {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    a = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    MARKS["CUDA start"] = time.perf_counter() - a
    log(f"[card] {kind}; {smi('name,power.limit,clocks.max.sm')}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    r = execute(root, args.workload, args.seed, args.seconds,
                bool(args.trace))
    res = r["window"]
    log(f"[clocks] before the window: {r['clocks'][0]}; after: "
        f"{r['clocks'][1]} (sm MHz, mem MHz, W, C)")
    log(f"[window] {res.calls} calls ({res.failed_calls} failed) in "
        f"{res.window_s:.6f} s; setup {r['setup_s']:.3f} s; memory peak "
        f"{r['peak']} B")
    log(f"[setup] " + ", ".join(f"{k} {v:.3f} s"
                                  for k, v in r["phases"].items())
        + "; warm-up calls (s): "
        + ", ".join(f"{v:.4f}" for v in r["warm_calls_s"]))
    per_s, t_acc, bucket = [], 0.0, []
    for v in res.step_s:
        t_acc += v
        bucket.append(v)
        if t_acc >= len(per_s) + 1:
            per_s.append(round(1e3 * sum(bucket) / len(bucket), 2))
            bucket = []
    log(f"[steps] mean ms a call, each second of the window: {per_s}")
    st = sorted(res.step_s)
    if st:
        q = [st[int(f * (len(st) - 1))] * 1e3 for f in (0, .25, .5, .75,
                                                        .95, 1)]
        log("[steps] ms min/q1/median/q3/p95/max: "
            + "/".join(f"{v:.3f}" for v in q)
            + f"; slowest 8: {[round(v * 1e3, 3) for v in st[-8:]]}")
    log(f"[kernels] launches per call: {r['launches_per_call']}")
    log(f"[track] tracked at the start {r['tracked_start']}, at the end "
        f"{r['tracked_end']}")
    log(f"[check] calls {r['checked_calls']} and the reference's own run "
        f"of {cell.traffic.own_calls} calls in {r['check_s']:.2f} s")
    for k, v in r["worst"].items():
        if k not in r["limits"]:
            log(f"[check] {k} {v!r} (not compared)")
    bad = guard.loaded()
    if bad:
        print(f"gpubench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    line = result_line(r, bool(args.trace), {"platform": "gpu", "kind": kind,
                                             "count": need})
    for ln in r["check_lines"]:
        print(f"[check] {ln}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0
