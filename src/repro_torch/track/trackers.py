"""Streaming per-round telemetry (`src/repro/track/trackers.py`, DESIGN.md
§10).

A `Tracker` is a host-side sink with the reference's protocol:

    tracker.log(round_idx, metrics)     # one scalar dict per round
    tracker.finish(summary)             # once, at the end of a run
    tracker.resume(round_idx)           # on a checkpoint restart

The port's rounds run eagerly, so there is no callback to splice into a
compiled round: the simulator calls `emit(r, diag)` (`emitter`) once per
round, right after that round's server section, and the emitter reads the
round's scalar diagnostics in one device-to-host copy.  `tracker="none"`
wires nothing: no copy, no operation, so an untracked run is what it was.

Sinks registered under the reference's names, options and defaults:

* ``none``      — no sink; the run is unchanged.
* ``jsonl``     — one JSON object per line, appended and flushed every row
  (a killed run keeps every completed round; `tools/flwatch.py` tails it).
  `resume(round_idx)` truncates rows past the restore point.
* ``csv``       — header from the first row's keys, one line per round.
* ``stdout``    — a line per round, rate-limited by ``every`` (round
  stride) and ``interval`` (least seconds between lines).
* ``memory``    — rows kept on the instance (`.rows`).
* ``composite`` — fan-out to child sinks.

Given the same rows, the file sinks write the reference's bytes.

Host-side enrichment (`emitter`): ``sec_per_round`` (wall time since the
previous row; `emit.reset()` restarts the clock at each dispatch) and
``bytes_up_cum`` (the running sum of ``bytes_up``, restored by
`emit.resume(last_row)` after a checkpoint restart); host publishers (the
host store's gauges, the serve coordinator's queue columns) merge their
keys into every later row through `emit.set_host_metrics`.

Phase scopes: `scope(name)` is `torch.profiler.record_function(name)` over
the reference's vocabulary (``client_pass`` / ``encode`` / ``aggregate`` /
``server_update``), so a `torch.profiler` trace maps operators back to the
round's phases.  A scope changes no computation.

Not ported: the reference's `tether`.  It makes XLA run each round's host
callback before the next round's compute (effect tokens alone let XLA defer
every callback to the end of a scan); an eager round has no such schedule
to fix, so the port needs no counterpart.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import typing as tp

import numpy as np
import torch

from repro_torch.utils.tree_math import ravel_stack

# ---------------------------------------------------------------------------
# phase vocabulary for torch.profiler traces (DESIGN.md §10.4)
# ---------------------------------------------------------------------------

CLIENT_PASS = "client_pass"
ENCODE = "encode"
AGGREGATE = "aggregate"
SERVER_UPDATE = "server_update"
PHASES = (CLIENT_PASS, ENCODE, AGGREGATE, SERVER_UPDATE)


def scope(name: str):
    """A profiler phase scope: labels the enclosed operators in a
    `torch.profiler` trace; changes nothing else."""
    return torch.profiler.record_function(name)


# Reserved aux key: with `FLConfig.track_variance` the client pass is
# wrapped (`with_grad_stats`) and every client uploads ||upload||^2, one f32
# scalar riding the aux dict like the sampler statistics, counted in
# bytes_up.
GNORM_KEY = "track_gnorm_sq"


# ---------------------------------------------------------------------------
# the Tracker protocol
# ---------------------------------------------------------------------------

class Tracker:
    """Base sink: `log(round_idx, metrics)` per round, `finish(summary)`
    once, `resume(round_idx)` on a checkpoint restart.

    `log` receives a plain dict of python floats (and the int round index).
    `resume` rewinds the sink to `round_idx` (a restored run re-streams the
    rounds after it) and returns the last surviving row (or None), from
    which the emitter restores `bytes_up_cum`."""

    name = "base"

    def log(self, round_idx: int, metrics: dict) -> None:
        raise NotImplementedError

    def finish(self, summary: dict | None = None) -> None:
        pass

    def resume(self, round_idx: int) -> dict | None:
        return None


class NullTracker(Tracker):
    """`tracker="none"`: the simulator wires no emitter for this sink.
    `log` still works (a no-op), so host-stepped callers need no branch."""

    name = "none"

    def log(self, round_idx: int, metrics: dict) -> None:
        pass


class MemoryTracker(Tracker):
    """Rows kept in memory (`.rows`: dicts with a "round" key)."""

    name = "memory"

    def __init__(self):
        self.rows: list[dict] = []
        self.summary: dict | None = None

    def log(self, round_idx: int, metrics: dict) -> None:
        self.rows.append(dict(round=int(round_idx), **metrics))

    def finish(self, summary: dict | None = None) -> None:
        if summary is not None:
            self.summary = dict(summary)

    def resume(self, round_idx: int) -> dict | None:
        self.rows = [r for r in self.rows if r["round"] <= round_idx]
        return self.rows[-1] if self.rows else None


class JsonlTracker(Tracker):
    """Append-per-round JSON lines, flushed every row.  Round rows carry a
    "round" key; `finish(summary)` appends one {"summary": ...} row, which
    `tools/flwatch.py` treats as terminal."""

    name = "jsonl"

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def log(self, round_idx: int, metrics: dict) -> None:
        self._f.write(json.dumps(dict(round=int(round_idx), **metrics))
                      + "\n")
        self._f.flush()

    def finish(self, summary: dict | None = None) -> None:
        if summary is not None:
            self._f.write(json.dumps(dict(summary=summary)) + "\n")
        self._f.flush()
        self._f.close()

    def resume(self, round_idx: int) -> dict | None:
        """Truncate rows past the restore point, so a reader never sees a
        round twice or an index that goes back.  Returns the last kept
        row."""
        self._f.close()
        kept, last = [], None
        if os.path.exists(self.path):
            with open(self.path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    row = json.loads(line)
                    # the restarted run's summary rows are stale too
                    if "round" in row and row["round"] <= round_idx:
                        kept.append(line)
                        last = row
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write("".join(ln + "\n" for ln in kept))
        os.replace(tmp, self.path)
        self._f = open(self.path, "a", encoding="utf-8")
        return last


class CsvTracker(Tracker):
    """One CSV line per round; the header is fixed by the first row's keys
    (later rows write those columns and ignore new keys)."""

    name = "csv"

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._keys: tuple[str, ...] | None = None

    def log(self, round_idx: int, metrics: dict) -> None:
        if self._keys is None:
            self._keys = ("round",) + tuple(sorted(metrics))
            if self._f.tell() == 0:
                self._f.write(",".join(self._keys) + "\n")
        row = dict(metrics, round=int(round_idx))
        self._f.write(",".join(repr(row[k]) if isinstance(row[k], str)
                               else f"{row[k]:g}" if k != "round"
                               else str(row[k])
                               for k in self._keys if k in row) + "\n")
        self._f.flush()

    def finish(self, summary: dict | None = None) -> None:
        self._f.flush()
        self._f.close()


class StdoutTracker(Tracker):
    """A line per round, at most one per `every` rounds and per `interval`
    seconds (both gates must pass; the first row always prints)."""

    name = "stdout"

    def __init__(self, every: int = 1, interval: float = 0.0, stream=None):
        self.every = max(int(every), 1)
        self.interval = float(interval)
        self._stream = stream or sys.stdout
        self._last_t: float | None = None

    def _fmt(self, k: str, v) -> str:
        if k == "bytes_up" or k == "bytes_up_cum":
            return f"{k}={v / 1024.0:.1f}KiB"
        return f"{k}={v:.4g}"

    def log(self, round_idx: int, metrics: dict) -> None:
        now = time.perf_counter()
        first = self._last_t is None
        if not first:
            if round_idx % self.every != 0:
                return
            if now - self._last_t < self.interval:
                return
        self._last_t = now
        line = f"round {round_idx:5d}  " + "  ".join(
            self._fmt(k, metrics[k]) for k in sorted(metrics))
        print(line, file=self._stream, flush=True)

    def finish(self, summary: dict | None = None) -> None:
        if summary is not None:
            line = "finish  " + "  ".join(
                f"{k}={v}" for k, v in sorted(summary.items()))
            print(line, file=self._stream, flush=True)


class CompositeTracker(Tracker):
    """Fan-out to child sinks in order (stdout for the terminal and jsonl
    for the record is the serve loop's default)."""

    name = "composite"

    def __init__(self, children: tp.Sequence[Tracker]):
        self.children = tuple(children)

    def log(self, round_idx: int, metrics: dict) -> None:
        for c in self.children:
            c.log(round_idx, metrics)

    def finish(self, summary: dict | None = None) -> None:
        for c in self.children:
            c.finish(summary)

    def resume(self, round_idx: int) -> dict | None:
        last = None
        for c in self.children:
            row = c.resume(round_idx)
            last = row if row is not None else last
        return last


# ---------------------------------------------------------------------------
# registry (the contract of every other strategy registry)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrackerSpec:
    """A registered sink: `factory(opts) -> Tracker`; `options` names what
    `FLConfig.make` accepts, `defaults` fills the omitted ones, `validate`
    rejects bad values at construction."""
    name: str
    factory: tp.Callable
    options: tuple = ()
    defaults: dict = dataclasses.field(default_factory=dict)
    validate: tp.Callable | None = None
    description: str = ""


_REGISTRY: dict[str, TrackerSpec] = {}


def register_tracker(spec: TrackerSpec, *,
                     overwrite: bool = False) -> TrackerSpec:
    """Register `spec` under `spec.name`; returns it for chaining."""
    if not overwrite and spec.name in _REGISTRY:
        raise ValueError(f"tracker '{spec.name}' is already registered")
    if set(spec.defaults) - set(spec.options):
        raise ValueError(
            f"tracker '{spec.name}' has defaults for undeclared options: "
            f"{sorted(set(spec.defaults) - set(spec.options))}")
    _REGISTRY[spec.name] = spec
    return spec


def get_tracker(name: str) -> TrackerSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown tracker '{name}'; registered: "
                       f"{sorted(_REGISTRY)}") from None


def registered_trackers() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_opts(spec: TrackerSpec, opts: dict | None) -> dict:
    """Merge user options over the sink's defaults, rejecting unknown names
    and bad values."""
    opts = dict(opts or {})
    bad = sorted(set(opts) - set(spec.options))
    if bad:
        raise TypeError(
            f"option(s) {bad} are not used by tracker '{spec.name}'; "
            f"valid options: {sorted(spec.options)}")
    resolved = {**spec.defaults, **opts}
    if spec.validate is not None:
        spec.validate(resolved)
    return resolved


def make_tracker(name: str, **opts) -> Tracker:
    """Validated construction: `make_tracker("jsonl", path="run.jsonl")`."""
    spec = get_tracker(name)
    return spec.factory(resolve_opts(spec, opts))


def _composite_factory(opts) -> CompositeTracker:
    return CompositeTracker([c if isinstance(c, Tracker) else make_tracker(c)
                             for c in opts["children"]])


def _composite_validate(opts):
    for c in opts["children"]:
        if not isinstance(c, (Tracker, str)):
            raise TypeError(f"composite children must be Tracker instances "
                            f"or registered names, got {type(c).__name__}")
        if isinstance(c, str):
            get_tracker(c)


def _stdout_validate(opts):
    if int(opts["every"]) < 1:
        raise ValueError(f"stdout tracker 'every' must be >= 1, got "
                         f"{opts['every']}")
    if float(opts["interval"]) < 0.0:
        raise ValueError(f"stdout tracker 'interval' must be >= 0, got "
                         f"{opts['interval']}")


register_tracker(TrackerSpec(
    name="none", factory=lambda opts: NullTracker(),
    description="no sink; the run is unchanged"))
register_tracker(TrackerSpec(
    name="memory", factory=lambda opts: MemoryTracker(),
    description="rows kept on the instance (.rows)"))
register_tracker(TrackerSpec(
    name="jsonl", factory=lambda opts: JsonlTracker(opts["path"]),
    options=("path",), defaults=dict(path="track.jsonl"),
    description="append-per-round JSON lines, flushed per row"))
register_tracker(TrackerSpec(
    name="csv", factory=lambda opts: CsvTracker(opts["path"]),
    options=("path",), defaults=dict(path="track.csv"),
    description="one CSV line per round (header from the first row)"))
register_tracker(TrackerSpec(
    name="stdout",
    factory=lambda opts: StdoutTracker(every=opts["every"],
                                       interval=opts["interval"]),
    options=("every", "interval"), defaults=dict(every=1, interval=0.0),
    validate=_stdout_validate,
    description="rate-limited human-readable line per round"))
register_tracker(TrackerSpec(
    name="composite", factory=_composite_factory,
    options=("children",), defaults=dict(children=()),
    validate=_composite_validate,
    description="fan-out to child sinks (instances or registered names)"))


def composite(*children: Tracker) -> CompositeTracker:
    """`composite(stdout_t, jsonl_t)`: programmatic fan-out."""
    return CompositeTracker(children)


# ---------------------------------------------------------------------------
# the per-round emission
# ---------------------------------------------------------------------------

def host_floats(values) -> list[float]:
    """Python floats of a list of 0-dim tensors and numbers, the tensors
    read in one device-to-host copy of their f32 stack; a number is rounded
    to f32 as the reference's f32 diagnostics are."""
    pos = [i for i, v in enumerate(values) if torch.is_tensor(v)]
    out = [None if torch.is_tensor(v) else float(np.float32(v))
           for v in values]
    if pos:
        stacked = torch.stack([values[i].detach().to(torch.float32)
                               for i in pos]).cpu().tolist()
        for i, v in zip(pos, stacked):
            out[i] = v
    return out


def emitter(tracker: Tracker):
    """Build `emit(r, metrics)`: streams round `r`'s scalar diagnostics
    (0-dim tensors or numbers) to `tracker` as one row and returns the
    row's metrics.  The tensors cross to the host in one copy.

    Host-side enrichment:
      * ``sec_per_round``: wall time since the previous row.  `emit.reset()`
        (called by the simulator at each dispatch) restarts the clock, so
        host work between dispatches (evaluation, checkpointing) is not
        charged to the next round.
      * ``bytes_up_cum``: running sum of the ``bytes_up`` diagnostic;
        `emit.resume(last_row)` restores it from a sink's surviving row
        after a checkpoint restart.
      * the metrics published with `emit.set_host_metrics`.
    """
    state = {"t": None, "bytes": 0.0, "host": {}}

    def emit(r, metrics):
        names = tuple(sorted(metrics))
        m = dict(zip(names, host_floats([metrics[k] for k in names])))
        now = time.perf_counter()
        m["sec_per_round"] = (now - state["t"]
                              if state["t"] is not None else 0.0)
        state["t"] = now
        state["bytes"] += m.get("bytes_up", 0.0)
        m["bytes_up_cum"] = state["bytes"]
        # host-side publishers' values, set before the round was dispatched
        m.update(state["host"])
        tracker.log(int(r), m)
        return m

    def reset():
        state["t"] = time.perf_counter()

    def resume(last_row: dict | None):
        state["t"] = None
        state["bytes"] = float((last_row or {}).get("bytes_up_cum", 0.0))

    def set_host_metrics(metrics: dict):
        """Publish host-side metrics to merge into every later row.  Merge,
        not replace: independent publishers (the host store's memory and
        overlap gauges, the serve coordinator's queue and admission
        counters) each own their keys."""
        state["host"].update({k: float(v) for k, v in metrics.items()})

    emit.reset = reset
    emit.resume = resume
    emit.set_host_metrics = set_host_metrics
    return emit


def with_grad_stats(client_fn):
    """Compose a ctx-signature client fn with the telemetry upload: each
    client's ||raw f32 upload||^2 rides the aux dict under `GNORM_KEY`
    ((C,) f32, 4 uploaded bytes a client), from which the server derives the
    cohort gradient-variance proxy E_w ||g_u||^2 - ||agg||^2.  Applied
    before the codec wrapper, like `sampling.with_stats`."""
    def fn(ctx, params, cstate, batches, key):
        out = client_fn(ctx, params, cstate, batches, key)
        vec, _ = ravel_stack(out.grad)
        aux = dict(out.aux, **{GNORM_KEY: torch.sum(vec * vec, dim=1)})
        return out._replace(aux=aux)
    return fn
