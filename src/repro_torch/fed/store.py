"""The per-client state store: where the (M, ...) tables live.

The counterpart of `src/repro/fed/store.py` (DESIGN.md §11).  Every
per-client table a run carries (FedNCV's alphas, SCAFFOLD's c_u, the
personal heads, FedNCV+'s h, FedGLOMO's momenta) is declared through the
method's `state_spec()`, so where the tables live is a store, registered
like the methods, samplers, aggregators and fault models:

* `device` — every table a tensor on the simulator's device; the cohort's
  rows are gathered and written back there.  M is bounded by device
  memory.
* `host`   — the per-client `StateField` tables and the client-indexed
  data (`images`, `labels`) stay in host memory (`HostTables`): page-locked
  (pinned) buffers when the simulator runs on the card, plain CPU tensors
  otherwise, and an `np.memmap` file past `spill_mb` MiB.  Each round only
  the cohort's slice reaches the device: a worker thread
  (`CohortPrefetcher`) writes the previous round's rows back, then gathers
  the next cohort's rows into a pinned staging buffer and copies it to the
  device on a side stream of its own (`Staging`).

What stays on the device under `host`: the sampler's and fault model's
M-tables, `client_sizes`, the params and the global (server) state.

Registering another store::

    register_store(StateStore(name="mine", host_resident=True,
                              make_tables=lambda opts, pin: MyTables(opts),
                              options=("knob",), defaults=dict(knob=1)))
"""
from __future__ import annotations

import dataclasses
import math
import os
import queue
import tempfile
import threading
import time
import typing as tp

import numpy as np
import torch

from repro_torch.utils.tree_math import tree_leaves, tree_map

__all__ = [
    "StateStore", "register_store", "get_store", "registered_stores",
    "resolve_opts", "HostTables", "CohortPrefetcher", "Staging",
    "row_ids", "host_mem_peak",
]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StateStore:
    """A per-client state store as one object.

    host_resident : False -> the tables are device tensors (`device`);
                    True -> they live behind `make_tables` and the
                    simulator stages the cohort's slice each round.
    make_tables   : (opts, pin) -> a `HostTables`-like backend (`pin`: use
                    page-locked memory), or None for a device store.
    options       : option names `FLConfig.make` accepts; `defaults` gives
                    their values when omitted.
    validate      : (opts) -> None, raises on bad option values.
    """
    name: str
    host_resident: bool = False
    make_tables: tp.Callable | None = None
    options: tuple = ()
    defaults: dict = dataclasses.field(default_factory=dict)
    validate: tp.Callable | None = None
    description: str = ""


_REGISTRY: dict[str, StateStore] = {}


def register_store(store: StateStore, *,
                   overwrite: bool = False) -> StateStore:
    if not overwrite and store.name in _REGISTRY:
        raise ValueError(f"store '{store.name}' is already registered; "
                         f"pass overwrite=True to replace it")
    _REGISTRY[store.name] = store
    return store


def get_store(name: str) -> StateStore:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown state store '{name}'; registered: "
                       f"{sorted(_REGISTRY)}") from None


def registered_stores() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def resolve_opts(store: StateStore, opts: dict | None) -> dict:
    """The user's options over the store's defaults; unknown names raise
    TypeError, bad values ValueError."""
    opts = dict(opts or {})
    bad = sorted(set(opts) - set(store.options))
    if bad:
        raise TypeError(
            f"option(s) {bad} are not used by store '{store.name}'; "
            f"valid options: {sorted(store.options)}")
    resolved = {**store.defaults, **opts}
    if store.validate is not None:
        store.validate(resolved)
    return resolved


# ---------------------------------------------------------------------------
# host-resident tables
# ---------------------------------------------------------------------------

def _as_cpu(x) -> torch.Tensor:
    return (x if torch.is_tensor(x) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(x)))).detach().cpu()


def row_ids(idx) -> torch.Tensor:
    """Row indices (an array, tensor or list) as a flat CPU int64 tensor."""
    return _as_cpu(idx).to(torch.int64).reshape(-1)


class HostTables:
    """Named host-resident (M, ...) tables (dicts of CPU tensors) with
    cohort-row gather and scatter.

    `pin`: the tables are page-locked, so a copy from a staging buffer to
    the card runs as DMA.  A table leaf larger than `spill_mb` MiB is an
    `np.memmap` file under `spill_dir` (a temporary directory by default),
    wrapped by `torch.from_numpy`; gather and scatter treat both alike."""

    def __init__(self, opts: dict | None = None, pin: bool = False):
        opts = opts or {}
        self._tables: dict[str, tp.Any] = {}
        self._spill_bytes = float(opts.get("spill_mb", float("inf"))) * 2**20
        self._spill_dir = opts.get("spill_dir") or None
        self._pin = bool(pin)
        self._n_spilled = 0
        self._spilled: set[int] = set()     # ids of memmap-backed leaves

    def _alloc(self, name, shape, dtype):
        one = torch.empty((), dtype=dtype)
        if math.prod(shape) * one.element_size() > self._spill_bytes:
            if self._spill_dir is None:
                self._spill_dir = tempfile.mkdtemp(prefix="repro-store-")
            os.makedirs(self._spill_dir, exist_ok=True)
            path = os.path.join(self._spill_dir,
                                f"{name}.{self._n_spilled}.mmap")
            self._n_spilled += 1
            t = torch.from_numpy(np.memmap(path, dtype=one.numpy().dtype,
                                           mode="w+", shape=tuple(shape)))
            self._spilled.add(id(t))
            return t
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=self._pin)

    def add(self, name: str, row_tree, m: int):
        """Table `name`: `m` copies of one per-client init row (every
        client starts from the same row, as the device store's init)."""
        i = [0]

        def mk(row):
            row = _as_cpu(row)
            t = self._alloc(f"{name}.{i[0]}", (m,) + tuple(row.shape),
                            row.dtype)
            i[0] += 1
            t.copy_(row.expand_as(t))
            return t
        self._tables[name] = tree_map(mk, row_tree)

    def adopt(self, name: str, tree):
        """Register existing arrays (the data) as a table, copied into
        page-locked memory when the tables are pinned."""
        def one(x):
            t = _as_cpu(x).contiguous()
            return t.pin_memory() if self._pin else t
        self._tables[name] = tree_map(one, tree)

    def get(self, name: str):
        return self._tables[name]

    def set(self, name: str, tree):
        """Overwrite a table in place (checkpoint restore): the buffers,
        pinned or memmap-backed, stay."""
        tree_map(lambda dst, src: dst.copy_(_as_cpu(src)), self._tables[name],
                 tree)

    def gather(self, names, idx, out=None):
        """Cohort windows {name: tree of (len(idx), ...) row copies}.
        `out` (name -> tree of buffers) receives the rows in place."""
        idx = row_ids(idx)
        res = {}
        for n in names:
            if out is None:
                res[n] = tree_map(lambda t: torch.index_select(t, 0, idx),
                                  self._tables[n])
            else:
                res[n] = tree_map(
                    lambda t, o: torch.index_select(t, 0, idx, out=o),
                    self._tables[n], out[n])
        return res

    def scatter(self, name: str, idx, rows, alive=None):
        """Write cohort rows back at `idx`.  `alive` ((cohort,) 0/1 or
        None): a dropped client's row is not written at all."""
        idx = row_ids(idx)
        rows = tree_map(_as_cpu, rows)
        if alive is not None:
            keep = _as_cpu(alive).reshape(-1) > 0
            if not bool(keep.all()):
                idx = idx[keep]
                rows = tree_map(lambda r: r[keep], rows)
            if idx.numel() == 0:
                return
        tree_map(lambda t, r: t.index_copy_(0, idx, r.to(t.dtype)),
                 self._tables[name], rows)

    def nbytes(self) -> int:
        return int(sum(x.numel() * x.element_size()
                       for t in self._tables.values()
                       for x in tree_leaves(t)))

    def spilled_bytes(self) -> int:
        return int(sum(x.numel() * x.element_size()
                       for t in self._tables.values()
                       for x in tree_leaves(t) if id(x) in self._spilled))


# ---------------------------------------------------------------------------
# the prefetch worker and the staging copies
# ---------------------------------------------------------------------------

class CohortPrefetcher:
    """One daemon worker thread behind a bounded queue.  The simulator
    submits a round's jobs (stage its batch rows; write the previous
    round's rows back, then stage its state windows) and waits for their
    results just before the round needs them.  FIFO order makes the
    write-after-read order structural: the job that gathers round r's rows
    runs after the one that wrote round r-1's.

    `overlap_frac` = 1 - blocked / busy: the share of the worker's staging
    time the caller did not wait for.  `enabled=False` (store option
    `prefetch=False`) runs each job inline on the caller."""

    def __init__(self, enabled: bool = True, depth: int = 2):
        self.enabled = enabled
        self.busy_s = 0.0       # worker seconds spent on jobs
        self.blocked_s = 0.0    # caller seconds spent waiting for a result
        self._err = None
        if enabled:
            self._q: queue.Queue = queue.Queue(maxsize=depth)
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, box, done = item
            t0 = time.perf_counter()
            try:
                box.append(fn())
            except BaseException as e:   # raised again on the caller
                self._err = e
            finally:
                self.busy_s += time.perf_counter() - t0
                done.set()

    def submit(self, fn):
        """Queue `fn`; returns a waiter that gives its result, raising the
        worker's exception on the caller."""
        if self._err is not None:
            raise self._err
        if not self.enabled:
            t0 = time.perf_counter()
            out = fn()
            self.busy_s += time.perf_counter() - t0
            return lambda: out

        box, done = [], threading.Event()
        self._q.put((fn, box, done))

        def wait():
            t0 = time.perf_counter()
            done.wait()
            self.blocked_s += time.perf_counter() - t0
            if self._err is not None:
                raise self._err
            return box[0]
        return wait

    def overlap_frac(self) -> float:
        if self.busy_s <= 0.0:
            return 0.0
        return float(min(1.0, max(0.0, 1.0 - self.blocked_s / self.busy_s)))

    def close(self):
        if self.enabled:
            self._q.put(None)
            self._thread.join(timeout=5.0)
            self.enabled = False


class Staging:
    """Host -> device copies of cohort slices, and device -> host copies
    of the rows a round wrote.

    On the card a job takes the next of `slots` sets of page-locked
    staging buffers, waiting first for that set's last copy to complete,
    so no buffer is rewritten while a copy still reads it; the caller's
    gather fills them, and `ship` copies them to the device with
    `non_blocking=True` on a side stream of its own and records an event;
    `Staged.ready` makes the round's stream wait on that event.  The side
    stream only copies, so it changes no sum.  On the CPU the gathered
    tensors are the staged ones."""

    def __init__(self, device: torch.device, slots: int = 3):
        self.device = device
        self.cuda = device.type == "cuda"
        self.bytes_in = 0       # bytes staged host -> device
        self.bytes_out = 0      # bytes copied device -> host
        self._slots = [({}, None) for _ in range(max(2, slots))]
        self._next = 0
        self._stream = torch.cuda.Stream(device) if self.cuda else None

    def buffers(self, like: dict):
        """(slot, buffers): buffers shaped like `like` (a tree of (shape,
        dtype) leaves) from the next slot, free to write."""
        i = self._next
        self._next = (i + 1) % len(self._slots)
        bufs, event = self._slots[i]
        if event is not None:
            event.synchronize()

        def mk(path, sd):
            if not self.cuda:
                return torch.empty(sd[0], dtype=sd[1])
            key = (path, tuple(sd[0]), sd[1])
            if key not in bufs:
                bufs[key] = torch.empty(sd[0], dtype=sd[1], pin_memory=True)
            return bufs[key]
        return i, _map_with_path(mk, like)

    def ship(self, slot: int, tree) -> "Staged":
        """`tree` (leaves in slot `slot`'s buffers) on the device."""
        self.bytes_in += sum(x.numel() * x.element_size()
                             for x in tree_leaves(tree))
        if not self.cuda:
            return Staged(tree, None, self.device)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            dev = tree_map(lambda x: x.to(self.device, non_blocking=True),
                           tree)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._slots[slot] = (self._slots[slot][0], event)
        return Staged(dev, event, self.device)

    def fetch(self, tree, after=None):
        """`tree`'s device tensors as (page-locked) CPU tensors, copied on
        the side stream once the event `after` (recorded by the round that
        wrote them) has completed; returns when the copies are done."""
        self.bytes_out += sum(x.numel() * x.element_size()
                              for x in tree_leaves(tree))
        if not self.cuda:
            return tree
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            if after is not None:
                self._stream.wait_event(after)
            out = tree_map(lambda x: torch.empty(
                x.shape, dtype=x.dtype, pin_memory=True).copy_(
                    x, non_blocking=True), tree)
        self._stream.synchronize()
        return out


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


class Staged(tp.NamedTuple):
    """A staged tree on the device and the event its copy recorded."""
    tree: tp.Any
    event: tp.Any
    device: tp.Any

    def ready(self):
        """The tree, once the caller's stream waits for its copy.  Its
        blocks are marked as used by that stream, so the caching allocator
        does not hand them out again while the round still reads them."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(self.event)
            for x in tree_leaves(self.tree):
                x.record_stream(stream)
        return self.tree


def host_mem_peak() -> int:
    """Peak resident set size of this process in bytes (0 where the
    platform gives none)."""
    try:
        import resource
        import sys
        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # linux reports KiB, macOS bytes
        return int(ru) * (1 if sys.platform == "darwin" else 1024)
    except Exception:
        return 0


# ---------------------------------------------------------------------------
# the two built-in stores
# ---------------------------------------------------------------------------

def _host_validate(opts):
    if opts["spill_mb"] <= 0:
        raise ValueError(f"spill_mb must be > 0, got {opts['spill_mb']}")


register_store(StateStore(
    name="device",
    host_resident=False,
    description="every (M, ...) table on the simulator's device"))

register_store(StateStore(
    name="host",
    host_resident=True,
    make_tables=lambda opts, pin: HostTables(opts, pin=pin),
    options=("spill_mb", "spill_dir", "prefetch"),
    defaults=dict(spill_mb=float("inf"), spill_dir=None, prefetch=True),
    validate=_host_validate,
    description="per-client tables and data in (pinned) host memory, with "
                "an optional memmap spill; only the cohort's slice is "
                "staged on the device, by a prefetch worker"))
