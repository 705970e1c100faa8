"""Per-phase simulation profiling and chrome-trace export (port of
``blub_tpu/runtime/profiler.py``).

The analog of the reference's GpuProfiler scopes around every dispatch
group (SURVEY.md section 5.1). ``profile_step`` runs the phases of one
substep of the port's slot-major path eagerly, one after another, with a
sync after each: a profiling mode, not the production path, which on the
card is one CUDA-graph replay per frame. ``PhaseTimer`` exports chrome://tracing
JSON like the reference's "Write Chrometrace" button (gui/mod.rs:484-517).

``trace(log_dir)`` wraps ``torch.profiler`` and writes its chrome trace;
``parse_phase_trace`` reads one back and gives the device time of each
``ph_*`` phase of ``sim/step_dense.step_core``: the kernels (ours are
launched through ctypes, which the profiler attributes to no host op) are
joined to the phases on the GPU timeline, where each ``ph_*`` range shows as
a ``gpu_user_annotation`` span. A graph replay has no ``ph_*`` ranges, so
per-phase attribution needs the eager path; the device time of a replayed
frame lands in "other".
"""

from __future__ import annotations

import contextlib
import gzip
import json
import pathlib
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

# JAX's profile_step phase names, in its order; the port times the same work
# under them (see profile_step for the two that its kernels fuse)
PHASES = (
    "marker", "p2g velocity", "divergence rhs", "pcg velocity", "divergence remove", "extrapolate",
    "advect (g2p+rk4)", "rebin +-2", "marker 2", "density gather", "density rhs", "pcg density",
    "position change", "correct particles", "rebin +-1",
)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")  # device activity in a torch.profiler trace


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Collects named phase durations across steps (ring of samples)."""

    def __init__(self, history: int = 100):
        self.history = history
        self.samples: Dict[str, List[float]] = {}
        self._events: List[dict] = []
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str, sync=None, scale: int = 1):
        """``sync``: a device to synchronise before the phase ends. ``scale``:
        the body ran the phase that many times; the sample is the per-run
        mean."""
        start = time.perf_counter()
        yield
        if sync is not None:
            _sync(torch.device(sync))
        self.add(name, start, (time.perf_counter() - start) / max(scale, 1))

    def add(self, name: str, start: float, dur: float) -> None:
        """Record one sample of ``dur`` seconds that began at ``start``
        (``time.perf_counter``)."""
        buf = self.samples.setdefault(name, [])
        buf.append(dur)
        if len(buf) > self.history:
            del buf[0]
        self._events.append(
            {"name": name, "ph": "X", "ts": (start - self._t0) * 1e6, "dur": dur * 1e6, "pid": 0, "tid": 0}
        )

    def mean_ms(self) -> Dict[str, float]:
        return {k: 1000.0 * float(np.mean(v)) for k, v in self.samples.items()}

    def report(self) -> str:
        rows = sorted(self.mean_ms().items(), key=lambda kv: -kv[1])
        total = sum(v for _, v in rows)
        lines = [f"{'phase':<28}{'ms':>9}  {'%':>5}"]
        for k, v in rows:
            lines.append(f"{k:<28}{v:9.2f}  {100*v/max(total,1e-9):5.1f}")
        lines.append(f"{'total':<28}{total:9.2f}")
        return "\n".join(lines)

    def write_chrometrace(self, path) -> pathlib.Path:
        """Chrome-trace JSON (load via chrome://tracing or Perfetto)."""
        path = pathlib.Path(path)
        path.write_text(json.dumps({"traceEvents": self._events}))
        return path


def profile_step(params, state, solids=None, repeats: int = 3):
    """Phase-by-phase timing of one substep of length params.dt on the
    slot-major path: each phase runs eagerly and the device is synchronised
    after it, so the times are wall times of the phases one at a time.
    Returns (mean ms per phase, the PhaseTimer); the first pass (kernel
    builds and loads) is dropped. The phases carry JAX's ``profile_step``
    names (``PHASES``). Where the port fuses two of them into one kernel,
    the kernel's time is under the first and the second is recorded as 0:
    "extrapolate" runs inside the gridfix kernel of "divergence remove"
    ("position change" extrapolates inside its own kernel, as in JAX), and
    "p2g velocity" is the P2G kernel plus the normalisation, between which
    "marker" is built from the kernel's fluid count. "advect (g2p+rk4)" and
    "correct particles" hold G2P fused with the x pack (``ops/advect_pack``,
    the rebin's x stage inside it) and "rebin +-2" / "rebin +-1" the y + z
    pack."""
    from ..ops import advect_pack, g2p, gridfix, p2g, pcg, rebin
    from ..sim.dense_transfer import density_rhs_from_raw
    from ..sim.divergence import compute_divergence_rhs
    from ..sim.sm_phases import marker_from_counts
    from ..sim.step_dense import stage_slack

    occupancy = solids.occupancy if solids is not None else None
    solid_vel = solids.velocity if solids is not None else None
    dt = np.float32(params.dt)
    grid = params.grid_dim
    table = state.table
    dev = table.posq.device
    k = table.capacity
    k_mid = k + stage_slack(grid, k)

    timer = PhaseTimer()
    for r in range(repeats + 1):
        times = {}  # name -> (start of its first part, seconds summed over its parts)

        def run(name, fn, *args):
            start = time.perf_counter()
            out = fn(*args)
            _sync(dev)
            s0, d0 = times.get(name, (start, 0.0))
            times[name] = (s0, d0 + time.perf_counter() - start)
            return out

        posq, dyn = table.posq, table.dyn
        acc = run("p2g velocity", p2g.p2g, posq, dyn)
        marker = run("marker", marker_from_counts, acc[-1], grid, occupancy)
        vel = run("p2g velocity", p2g.normalize_velocity, acc, marker, params.gravity_grid, dt)
        rhs = run("divergence rhs", compute_divergence_rhs, vel, marker, solid_vel)
        res = run("pcg velocity", pcg.solve_pressure, state.pressure_vel, rhs, marker, params.solver_vel, dt)
        vel = run("divergence remove", gridfix.gridfix_remove, vel, res.pressure, marker, solid_vel)
        times["extrapolate"] = (time.perf_counter(), 0.0)
        posq, dyn, _ = run("advect (g2p+rk4)", advect_pack.advect_pack, posq, vel, dt, occupancy, solid_vel, k_mid)
        posq, dyn, _ = run("rebin +-2", rebin.pack_yz, posq, dyn, g2p.ADVECT_SHIFT, k)
        dacc = run("density gather", p2g.p2g, posq, None, True)
        marker2 = run("marker 2", marker_from_counts, dacc[1], grid, occupancy)
        drhs = run("density rhs", density_rhs_from_raw, dacc[0], marker2, dt)
        res2 = run("pcg density", pcg.solve_pressure, state.pressure_den, drhs, marker2, params.solver_den, dt)
        change = run("position change", gridfix.gridfix_change, res2.pressure, marker2, dt)
        posq, dyn = run("correct particles", advect_pack.correct_pack, posq, dyn, change, marker2, k_mid)
        run("rebin +-1", rebin.pack_yz, posq, dyn, g2p.CORRECT_SHIFT, k)
        if r == 0:
            continue  # the first pass builds and loads the kernels
        for name in PHASES:
            timer.add(name, *times[name])
    return timer.mean_ms(), timer


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` over the block (host ops and, on a card, device
    activity); on exit its chrome trace is written to
    ``<log_dir>/blub.trace.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = pathlib.Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "blub.trace.json"))


def trace_events(path) -> list:
    """The events of a chrome trace: ``path`` is the file, or a directory
    whose newest ``*.trace.json`` / ``*.trace.json.gz`` is read."""
    path = pathlib.Path(path)
    if path.is_dir():
        files = sorted(list(path.rglob("*.trace.json")) + list(path.rglob("*.trace.json.gz")),
                       key=lambda p: p.stat().st_mtime)
        if not files:
            raise FileNotFoundError(f"no *.trace.json under {path}")
        path = files[-1]
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def parse_phase_trace(path) -> Dict[str, float]:
    """Device ms per ``ph_*`` phase of a torch.profiler chrome trace (a file,
    or the newest under a directory): the time of every device event
    (kernel, memcpy, memset) inside the phase's ``gpu_user_annotation``
    span on the GPU timeline, summed over the phase's calls, and under
    "other" the device time outside every ``ph_*`` span (graph replays,
    copies between frames). The port's ``ph_*`` ranges follow one another
    and do not nest."""
    events = trace_events(path)
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES)
    out: Dict[str, float] = {}
    inside = 0.0
    for e in events:
        if e.get("cat") == "gpu_user_annotation" and e.get("name", "").startswith("ph_"):
            a0, a1 = e["ts"], e["ts"] + e["dur"]
            busy = sum(max(0.0, min(a1, b1) - max(a0, b0)) for b0, b1 in device) / 1e3
            out[e["name"]] = out.get(e["name"], 0.0) + busy
            inside += busy
    out["other"] = max(0.0, sum(b1 - b0 for b0, b1 in device) / 1e3 - inside)
    return out


def profile_trace(fn, *args, log_dir=None, runs: int = 1) -> Dict[str, float]:
    """Run ``fn(*args)`` (already warm: build the kernels and capture any
    graphs first) ``runs`` times under the profiler and return device ms per
    phase and run (``parse_phase_trace``), largest first."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="blub_trace_")
    with trace(log_dir):
        for _ in range(runs):
            fn(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    phases = parse_phase_trace(log_dir)
    return {k: v / max(runs, 1) for k, v in sorted(phases.items(), key=lambda kv: -kv[1])}
