"""Launch planning shared by the port's one-launch reductions.

`ncv_weighted_sum` (`rloo/csrc/rloo.cu`) and `rank_band_mean`'s register
path (`robust/csrc/robust.cu`) stream an (M, N) f32 stack with V-float
vector loads, and `ncv_weighted_sum_q` / `_q4` (`rloo/csrc/rloo_q.cu`) an
(M, bytes) int8 / packed-int4 wire with V-byte loads, over a grid that
strides across the columns.  All four finish ||agg||^2 in the same launch
through `csrc/reduction.cuh::grid_sum`: each block writes a partial, and the
last block to draw an integer ticket sums the partials in index order.  This
module picks V and the grid, hands out the tickets' slots, and checks on the
card that a reduction gives the same bits however it is launched
(`check_replays`).
"""
from __future__ import annotations

import threading

import torch

THREADS = 256                  # threads a block (the kernels' kThreads)
SMS = 132                      # streaming multiprocessors of an H100 SXM
GRID_CAP = 4 * SMS             # a few blocks per SM; more columns stride
TICKET_SLOTS = 1 << 16         # csrc/reduction.cuh::kTicketSlots


def vector_width(n: int, *tensors: torch.Tensor) -> int:
    """Floats per load: the widest of 4, 2, 1 that divides N and whose
    4 V-byte alignment every tensor's data pointer meets.  N = 62,006 rows
    start 8 bytes off a 16-byte boundary at every odd row, so V = 2."""
    for v in (4, 2):
        if n % v == 0 and all(t.data_ptr() % (4 * v) == 0 for t in tensors):
            return v
    return 1


def vector_width_bytes(row_bytes: int, unit: int, *tensors: torch.Tensor,
                       widest: int = 16) -> int:
    """Bytes per load: the widest of 16, 8, 4, 2, 1 (up to `widest`) that
    divides `unit` (the row segment a vector must not straddle: a chunk of
    int8 codes, half a chunk of packed int4), divides the row's length in
    bytes, and whose alignment every tensor's data pointer meets.  Chunk
    512 gives 16; chunk 100 gives 4 (int8) and 2 (int4, half-chunk 50)."""
    for v in (16, 8, 4, 2):
        if v <= widest and unit % v == 0 and row_bytes % v == 0 and all(
                t.data_ptr() % v == 0 for t in tensors):
            return v
    return 1


def grid_blocks(n_items: int, threads: int = THREADS) -> int:
    """Blocks for `n_items` thread-sized work items: one item a thread up to
    GRID_CAP blocks, then the threads stride.  It depends on N and V alone,
    so the order of every sum is the same from call to call."""
    return max(1, min(-(-n_items // threads), GRID_CAP))


class _Tickets:
    """Slots of `reduction.cuh::grid_tickets`.  A slot serves launches that
    never overlap: all eager calls on one (device, stream) run in stream
    order, so they share one; a call captured into a CUDA graph gets a slot
    of its own for good, since the graph may be replayed on any stream."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_stream: dict = {}
        self._used = 0

    def _fresh(self) -> int:
        if self._used == TICKET_SLOTS:
            raise RuntimeError(f"all {TICKET_SLOTS} grid-sum ticket slots are "
                               f"taken (one per stream and per call captured "
                               f"into a CUDA graph)")
        self._used += 1
        return self._used - 1

    def slot(self, device: torch.device, stream: torch.cuda.Stream) -> int:
        with self._lock:
            if torch.cuda.is_current_stream_capturing():
                return self._fresh()
            key = (device.index, stream.cuda_stream)
            if key not in self._by_stream:
                self._by_stream[key] = self._fresh()
            return self._by_stream[key]


_TICKETS = _Tickets()


def ticket_slot(device: torch.device, stream: torch.cuda.Stream) -> int:
    """The ticket slot a launch on `stream` (current on `device`) uses."""
    return _TICKETS.slot(device, stream)


def check_replays(call, inputs, replays: int = 20) -> None:
    """Raise AssertionError unless `call(x)` (a tuple of CUDA tensors) gives
    its eager result bitwise when captured into a CUDA graph and replayed
    `replays` times, and when called on a stream of its own per input, all
    streams at once (each drawing its own ticket slot)."""
    eager = [tuple(t.clone() for t in call(x)) for x in inputs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm-up outside the capture
        call(inputs[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = call(inputs[0])
    for i in range(replays):
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(static, eager[0])):
            raise AssertionError(f"graph replay {i} differs from the eager "
                                 f"call")
    streams = [torch.cuda.Stream() for _ in inputs]
    outs = [[] for _ in inputs]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for _ in range(replays):
        for st, x, out in zip(streams, inputs, outs):
            with torch.cuda.stream(st):
                out.append(call(x))
    torch.cuda.synchronize()
    for k, (out, want) in enumerate(zip(outs, eager)):
        if not all(torch.equal(a, b) for o in out for a, b in zip(o, want)):
            raise AssertionError(f"a call on stream {k} of {len(inputs)} at "
                                 f"once differs from the eager call")
