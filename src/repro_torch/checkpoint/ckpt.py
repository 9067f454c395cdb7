"""Tree checkpoints in the reference's file format, and the simulator's.

The counterpart of `src/repro/checkpoint/ckpt.py`.  A checkpoint is
`<dir>/<step>.ckpt`, published atomically: one msgpack map
{flat_key: {dtype, shape, data}} with a `_meta` entry last.  Keys join the
tree path with '/', in the reference's leaf order (dict keys sorted, list
items in order); `data` is the leaf's raw little-endian bytes.  The
msgpack codec is `_msgpack.py`, so the port needs no `msgpack` package; a
file either package writes, the other reads.

`save_sim` / `restore_sim` checkpoint a `fed.Simulator` with the
reference's meta and refusals, plus two things of the port's own: the
in-flight pendings of a pipelined run (`pipeline/ring/<i>/...`, and
`pipeline/pidx` under the host store), and the states of the simulator's
three draw generators (`rng/gen`, `rng/fgen`, `rng/ugen`).  The reference
derives each round's key from the round index; the port draws from
stateful generators, so a restored run draws what the uninterrupted run
would have drawn only because the checkpoint carries their states.
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.utils.tree_math import tree_map

# dtypes numpy has no name for, kept as raw bits of an integer of their
# width
_BITS = {torch.bfloat16: ("bfloat16", torch.int16, np.int16)}
_BY_NAME = {name: (dt, np_int) for dt, (name, _, np_int) in _BITS.items()}


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _leaves_with_path(tree, path=()):
    """(path, leaf) in the reference's order; None leaves are skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _leaves_with_path(t, path + (i,))]
    return [(path, tree)]


def _entry(leaf) -> dict:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _BITS:
            name, as_int, _ = _BITS[t.dtype]
            return dict(dtype=name, shape=list(t.shape),
                        data=t.view(as_int).numpy().tobytes())
        leaf = t.numpy()
    a = np.asarray(leaf)
    return dict(dtype=str(a.dtype), shape=list(a.shape), data=a.tobytes())


def _tensor(spec) -> torch.Tensor:
    shape = tuple(spec["shape"])
    if spec["dtype"] in _BY_NAME:
        dt, np_int = _BY_NAME[spec["dtype"]]
        a = np.frombuffer(spec["data"], dtype=np_int).reshape(shape)
        return torch.from_numpy(a.copy()).view(dt)
    a = np.frombuffer(spec["data"], dtype=np.dtype(spec["dtype"]))
    return torch.from_numpy(a.reshape(shape).copy())


def save(path: str, tree, meta: dict | None = None):
    payload = {_key(p): _entry(x) for p, x in _leaves_with_path(tree)}
    payload["_meta"] = meta or {}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_msgpack.packb(payload))
    os.replace(tmp, path)          # atomic publish


def _read_payload(path: str):
    with open(path, "rb") as f:
        return _msgpack.unpackb(f.read())


def _fill(like, flat, path=()):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _fill(v, flat, path + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_fill(v, flat, path + (i,))
                          for i, v in enumerate(like))
    return flat[_key(path)]


def restore(path: str, like, payload=None):
    """Restore into the structure of `like` (a template tree) as CPU
    tensors; returns (tree, meta).  An already-decoded `payload` skips the
    file read."""
    if payload is None:
        payload = _read_payload(path)
    payload = dict(payload)
    meta = payload.pop("_meta", {})
    want = [_key(p) for p, _ in _leaves_with_path(like)]
    missing = set(want) - set(payload)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]}...")
    flat = {k: _tensor(payload[k]) for k in want}
    return _fill(like, flat), meta


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.fullmatch(r"(\d+)\.ckpt", f))]
    return max(steps) if steps else None


def save_step(directory: str, step: int, tree, meta=None, keep: int = 3):
    save(os.path.join(directory, f"{step}.ckpt"), tree,
         dict(meta or {}, step=step))
    steps = sorted(int(re.fullmatch(r"(\d+)\.ckpt", f).group(1))
                   for f in os.listdir(directory)
                   if re.fullmatch(r"\d+\.ckpt", f))
    for s in steps[:-keep]:
        os.remove(os.path.join(directory, f"{s}.ckpt"))


def _step_path(directory: str, step: int | None) -> str:
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    return os.path.join(directory, f"{step}.ckpt")


def restore_step(directory: str, like, step: int | None = None):
    return restore(_step_path(directory, step), like)


def read_meta(directory: str, step: int | None = None) -> dict:
    """A checkpoint's meta dict, without restoring its tree."""
    return _read_payload(_step_path(directory, step)).get("_meta", {})


# ---------------------------------------------------------------------------
# the FL simulator: params, every state field, the in-flight pipeline and
# the draw generators
# ---------------------------------------------------------------------------

def save_sim(directory: str, sim, meta=None, keep: int = 3):
    """Checkpoint a `fed.Simulator` at its current round.

    Writes the params, the whole state dict the method's `state_spec()`
    declares (with the sampler's and fault model's tables), the in-flight
    pendings of a pipelined run and the draw generators' states; the meta
    names the method, codec, sampler, aggregator, fault model and store,
    the pipeline depth and the state keys, for `restore_sim`'s checks.
    Under the host store the per-client tables are written from their host
    tensors under the same keys, so the format does not depend on the
    store."""
    state = sim._get_state()
    tree = dict(params=sim.params, state=state,
                rng={k: g.get_state() for k, g in sim._generators().items()})
    fl = sim.fl
    meta_d = dict(meta or {}, round_idx=sim.round_idx, method=fl.method,
                  codec=fl.codec, sampler=fl.sampler,
                  aggregator=fl.aggregator, fault=fl.fault, store=fl.store,
                  staleness=fl.staleness, state_keys=sorted(state))
    pipe = sim.pipeline_state()
    if pipe is not None:
        tree["pipeline"] = pipe
        meta_d["pipeline_inflight"] = len(pipe["ring"])
    save_step(directory, sim.round_idx, tree, meta_d, keep=keep)


def restore_sim(directory: str, sim, step: int | None = None):
    """Restore a `save_sim` checkpoint into `sim`, which must be built with
    the same FLConfig (checked against the meta, with the reference's
    refusals); returns the meta.

    A checkpoint with a pipeline restores its in-flight pendings, so the
    run goes on where it stopped; one without (a sync run, or one saved
    before the first cohort was issued) leaves a fresh pipeline.  A
    checkpoint with generator states (`rng/...`) restores them, so the
    resumed run draws what the uninterrupted one would have; one without
    them, such as one the reference wrote, leaves the simulator's
    generators as they are."""
    from repro_torch.fed import aggregators, api, faults, sampling

    path = _step_path(directory, step)
    payload = _read_payload(path)
    saved = payload.get("_meta", {})
    for key, roster in (("method", api.registered_methods()),
                        ("sampler", sampling.registered_samplers()),
                        ("aggregator", aggregators.registered_aggregators()),
                        ("fault", faults.registered_faults())):
        have = saved.get(key)
        if have is not None and have not in roster:
            raise ValueError(
                f"checkpoint names {key}={have!r}, which is not registered "
                f"in this build — registered {key}s: {sorted(roster)}")
    # an absent method or codec key takes the configured value; an absent
    # sampler, aggregator, fault or store key means the checkpoint was
    # written under the default
    fl = sim.fl
    for key, want, absent in (("method", fl.method, fl.method),
                              ("codec", fl.codec, fl.codec),
                              ("sampler", fl.sampler, "uniform"),
                              ("aggregator", fl.aggregator, "mean"),
                              ("fault", fl.fault, "none"),
                              ("store", fl.store, "device")):
        have = saved.get(key, absent)
        if have != want:
            raise ValueError(
                f"checkpoint was saved with {key}={have!r} but the "
                f"simulator is configured with {key}={want!r}")
    want_keys = sorted(sim._get_state())
    have_keys = sorted(saved.get("state_keys", want_keys))
    if have_keys != want_keys:
        raise ValueError(
            f"checkpoint state layout {have_keys} does not match the "
            f"simulator's state_spec() layout {want_keys} (same method "
            f"name, different state fields — version skew?)")
    has_pipe = any(k.startswith("pipeline/") for k in payload)
    if has_pipe:
        saved_k = saved.get("staleness")
        if saved_k is not None and saved_k != fl.staleness:
            raise ValueError(
                f"checkpoint carries an in-flight pipeline saved with "
                f"staleness={saved_k} but the simulator is configured "
                f"with staleness={fl.staleness}")
    like = dict(params=sim.params, state=sim._get_state())
    if has_pipe:
        like["pipeline"] = sim.pipeline_template(
            n_inflight=saved.get("pipeline_inflight"))
    gens = sim._generators()
    if any(k.startswith("rng/") for k in payload):
        like["rng"] = {k: g.get_state() for k, g in gens.items()}
    tree, meta = restore(path, like, payload=payload)
    sim.params = tree_map(lambda x: x.to(sim.device), tree["params"])
    sim._set_state(tree["state"])
    sim.round_idx = int(meta.get("round_idx", sim.round_idx))
    sim.set_pipeline_state(tree.get("pipeline"))
    for k, s in tree.get("rng", {}).items():
        gens[k].set_state(s)
    return meta
