"""Multi-pod dry run: every (arch x shape x mesh) cell's sharded step run
as rank 0 of a fake 256- or 512-rank process group.  The port of
`repro.launch.dryrun`.

    python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both [--device cpu]
        [--microbatches N]

The JAX module lowers and compiles each cell for 256 or 512 placeholder
devices and reads XLA's memory, cost and collective analyses; it never
runs the step.  PyTorch compiles nothing for N devices.  Here one process
joins a ``"fake"`` process group of 256 (512) ranks as rank 0, builds the
production mesh over it, places its own block of every argument as a
DTensor (the global state is never built: full qwen2.5-14b in f32 with
AdamW is about 176 GB, its block 1.08 GB) and runs the DTensor step
eagerly, once under `roofline.count_collectives`.  The fake group's
collectives return at once: they move no data and leave their outputs
unwritten, so the dry run never reads a value, as the JAX compile never
runs one; no shape in the model depends on a value.  On the card the rank
computes its block at full width, so its peak memory is measured, not
modelled, and the kernels launch on its block.

Each cell proves, as the JAX dry run does, that the placements are
coherent (every op has a sharding rule, the collectives exist) and that
the rank's memory fits, and records the roofline inputs.

Skips (recorded, as the JAX module records them):
  * long_500k for pure full-attention archs (needs sub-quadratic attention),
  * decode shapes for encoder-only archs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch import _build
from repro_torch._tree import tree_leaves, tree_map
from repro_torch.configs.base import (ALIASES, ARCH_IDS, SHAPE_BY_NAME, SHAPES,
                                      ArchConfig, ShapeSpec, get_config,
                                      input_specs)
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh
from repro_torch.train import train_step as ts

__all__ = ["skip_reason", "default_microbatches", "compile_cell", "run_cell",
           "main"]

# the seed of the values in every rank's blocks (never read: see above)
_SEED = 0


def skip_reason(cfg: ArchConfig, shape: ShapeSpec) -> Optional[str]:
    if shape.kind == "decode" and not cfg.supports_decode:
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return "long_500k needs sub-quadratic attention (pure-attention arch)"
    return None


def default_microbatches(cfg: ArchConfig, shape: ShapeSpec,
                         multi_pod: bool = False) -> int:
    if shape.kind != "train":
        return 1
    # per-DEVICE microbatch must stay >= 1: nm <= global_batch / dp_ways
    dp = 32 if multi_pod else 16
    cap = max(1, shape.global_batch // dp)
    # keep per-device microbatch activation footprint moderate; the GShard
    # dispatch tensor (B,S,E,C) makes MoE activations ~4x heavier
    want = 16 if cfg.family == "moe" else \
        (8 if shape.global_batch * shape.seq_len >= 2 ** 20 else 4)
    return min(want, cap)


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


@contextlib.contextmanager
def _fake_group(n_chips: int):
    """A ``"fake"`` default process group of ``n_chips`` ranks with this
    process as rank 0, destroyed on exit; inside a fake group of that
    size already running (`main`'s, one a mesh), that one.  Raises
    ``RuntimeError`` while any other group runs."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_backend() == "fake" and \
                dist.get_world_size() == n_chips:
            yield
            return
        raise RuntimeError(f"dryrun: a {dist.get_backend()} process group "
                           f"of {dist.get_world_size()} ranks is running; "
                           f"the dry run starts its own fake group of "
                           f"{n_chips}")
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=n_chips,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_shape(shape, placements, mesh):
    """This rank's block of a tensor of global ``shape`` under
    ``placements``: DTensor's split (`torch.chunk`'s: blocks of ceil(n /
    k), the last ones shorter or empty), mesh dim by mesh dim."""
    coord = mesh.get_coordinate()
    size = list(shape)
    for m, p in enumerate(placements):
        if p.is_shard():
            k, n = mesh.size(m), size[p.dim]
            chunk = -(-n // k)
            size[p.dim] = max(0, min(n, (coord[m] + 1) * chunk)
                              - coord[m] * chunk)
    return tuple(size)


def _blocks(tree, shardings, mesh, gen, high=None):
    """A DTensor of each "meta" leaf of ``tree`` built from this rank's
    block alone (`DTensor.from_local` with the global shape): floating
    blocks uniform in [0, 0.02) from ``gen``, integer blocks uniform in
    [0, ``high``) (zeros without ``high``), on ``gen``'s device."""
    from torch.distributed.tensor import DTensor

    def one(x, pl):
        shape = _local_shape(x.shape, pl, mesh)
        if x.dtype.is_floating_point:
            local = torch.rand(shape, generator=gen, device=gen.device,
                               dtype=x.dtype).mul_(0.02)
        elif high:
            local = torch.randint(0, high, shape, generator=gen,
                                  device=gen.device, dtype=x.dtype)
        else:
            local = torch.zeros(shape, dtype=x.dtype, device=gen.device)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=x.shape,
                                  stride=torch.empty(x.shape,
                                                     device="meta").stride())
    return tree_map(one, tree, shardings)


def _local_blocks(tree):
    """This rank's blocks of every tensor leaf of ``tree`` (a plain tuple
    of trees too: a step's arguments or outputs)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return [b for t in tree for b in _local_blocks(t)]
    return [x.to_local() if isinstance(x, DTensor) else x
            for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _local_bytes(tree) -> int:
    """The bytes this rank holds of every tensor leaf of ``tree``."""
    return sum(x.numel() * x.element_size() for x in _local_blocks(tree))


def _flop_counter():
    """``(on_local, total)``: a `roofline.count_collectives` ``on_local``
    hook adding each local op's FLOPs to ``total[0]`` by
    `torch.utils.flop_counter.FlopCounterMode`'s formulas.  The hook sees
    the ops DTensor has lowered to this rank's blocks (FlopCounterMode
    alone would read a DTensor's global shapes); ops that are no aten op
    (the CUDA kernels, called on blocks) count nothing."""
    from torch.utils.flop_counter import FlopCounterMode
    registry = FlopCounterMode(display=False).flop_registry
    total = [0]

    def on_local(func, args, kwargs, out):
        count = registry.get(func._overloadpacket)
        if count is not None:
            total[0] += count(*args, **kwargs, out_val=out)
    return on_local, total


def _cell_step(cfg: ArchConfig, shape: ShapeSpec, mesh, hyper, device: str,
               cache_update: str = "dus",
               replicate_params_over_data: bool = False):
    """``(step, args)`` of a cell: the placed step of its kind and this
    rank's blocks of its arguments; train cells take ``hyper``.  Prefill
    cells run the CUDA kernels on the card and the plain versions on the
    CPU."""
    gen = torch.Generator(device).manual_seed(_SEED)
    spec = input_specs(cfg, shape)
    if shape.kind == "train":
        step, astate, st_shard, bshard = ts.jit_train_step(cfg, mesh, hyper,
                                                           shape)
        state = _blocks(astate, st_shard, mesh, gen)
        batch = _blocks({k: spec[k] for k in bshard}, bshard, mesh, gen,
                        high=cfg.vocab)
        return step, (state, batch)
    if shape.kind == "prefill":
        step, aparams, (pshard, bshard) = ts.jit_prefill(
            cfg, mesh, shape, impl="kernel" if device == "cuda" else "ref",
            replicate_params_over_data=replicate_params_over_data)
        params = _blocks(aparams, pshard, mesh, gen)
        batch = _blocks({k: spec[k] for k in bshard}, bshard, mesh, gen,
                        high=cfg.vocab)
        return step, (params, batch)
    step, aparams, acaches, (pshard, cshard, bshard) = ts.jit_decode_step(
        cfg, mesh, shape, cache_update=cache_update,
        replicate_params_over_data=replicate_params_over_data)
    params = _blocks(aparams, pshard, mesh, gen)
    caches = _blocks(acaches, cshard, mesh, gen)
    tokens = _blocks(spec["tokens"], bshard["tokens"], mesh, gen,
                     high=cfg.vocab)
    return step, (params, caches, tokens, 0)


def _arg_bytes(cfg, shape, args) -> int:
    """The local bytes of every argument the step reads, as XLA counts a
    compiled step's arguments (`jax.jit` drops an argument its function
    never reads): the encoder's MLP is a GELU of ``w_up`` and ``w_down``,
    so its prefill never reads ``w_gate`` (kept in the tree, as in the
    JAX package; a train step's AdamW reads it); a decode step's
    position, a plain int, as the 0-d int32 `input_specs` gives it (JAX
    passes ``jnp.int32(0)``)."""
    n = _local_bytes(args)
    if cfg.family == "encoder" and shape.kind == "prefill":
        n -= _local_bytes(args[0]["layers"]["mlp"]["w_gate"])
    if shape.kind == "decode":
        pos = input_specs(cfg, shape)["pos"]
        n += pos.numel() * pos.element_size()
    return n


def _run_measured(step, args, device: str):
    """One call of ``step(*args)`` under `roofline.count_collectives`
    (with each collective's site), its FLOPs counted (`_flop_counter`):
    ``(out, stats, flops, seconds, peak)``, ``peak`` the bytes allocated
    on the card above what was allocated before the call, at the call's
    peak (None on the CPU)."""
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    on_local, flops = _flop_counter()
    out, stats = rl.count_collectives(step, *args, sites=True,
                                      on_local=on_local)
    if cuda:
        torch.cuda.synchronize()
    seconds = time.time() - t0
    peak = torch.cuda.max_memory_allocated() - base if cuda else None
    return out, stats, flops[0], seconds, peak


def _counts(counter, before) -> Dict[str, int]:
    """What ``counter`` gained since its copy ``before``."""
    return {k: v - before.get(k, 0) for k, v in counter.items()
            if v != before.get(k, 0)}


def _state_bytes(shape, out) -> int:
    """The local bytes of a step's state part, what JAX donates: a train
    step's new state, a decode step's caches; 0 for a prefill."""
    if shape.kind == "train":
        return _local_bytes(out[0])
    if shape.kind == "decode":
        return _local_bytes(out[1])
    return 0


def _alias_bytes(args, out) -> int:
    """The local bytes of the outputs written into an argument's storage,
    XLA's ``alias_size_in_bytes``: a decode step's caches, which its step
    consumes (`train_step.jit_decode_step`); 0 for a train step (the
    state is not donated: the port's AdamW returns a new state) and for
    a prefill."""
    given = {x.data_ptr() for x in _local_blocks(args) if x.numel()}
    return sum(x.numel() * x.element_size() for x in _local_blocks(out)
               if x.numel() and x.data_ptr() in given)


def compile_cell(cfg: ArchConfig, shape: ShapeSpec, multi_pod: bool,
                 hyper: Optional[ts.TrainHyper] = None,
                 device: str = "cuda") -> Dict:
    """One cell's record from one call of its step, with the JAX record's
    keys in the port's meaning:

      * ``lower_s``: building the step and placing this rank's blocks;
        ``compile_s``: the first call, mostly DTensor's sharding
        propagation (nothing is compiled); ``kernel_launches`` and
        ``plain_calls``: the CUDA kernels and plain versions the first
        call ran (`_build`'s counters);
      * ``memory_analysis``: ``argument_bytes`` the local bytes of every
        argument, ``output_bytes`` those of the outputs (``state_bytes``
        of them the new state, or a decode's caches), ``alias_bytes``
        those of the outputs written into an argument's storage
        (`_alias_bytes`: a decode's caches, which its step consumes as
        JAX's donated step does; 0 for a train cell, whose state is not
        donated, and for a prefill), ``temp_bytes`` on the card the peak
        of `torch.cuda.max_memory_allocated` over the first call less
        what was allocated before it and less the outputs not aliased,
        on the CPU -1 (as JAX writes -1 for a cost it lacks);
        ``per_device_bytes`` arguments, temporaries and outputs less the
        alias, as the JAX record sums them (on the card the measured
        peak with the arguments, on the CPU arguments and outputs less
        the alias); ``fits_hbm`` against the card's `HBM_BYTES`;
      * ``cost_analysis_raw.flops``: `_flop_counter` over the same
        call, this rank's FLOPs (train cells' remat recompute included;
        one call, not two: a train step of full qwen2.5-14b takes minutes
        of host time on the card); ``bytes_accessed`` -1;
      * ``collectives``: `roofline.count_collectives` of the first call
        (``tpu_corrected`` equals ``total``), ``ops`` its count,
        ``by_site`` its bytes by ``"<kind> <site>"`` (the frame of the
        port that issued each, `roofline.count_collectives`);
      * ``analytic``, ``roofline``: `roofline.analytic_costs` and
        `roofline.roofline_terms` with the counted bytes, as JAX.

    Runs inside a fake group of the mesh's size (`_fake_group`)."""
    return _measure_cell(cfg, shape, multi_pod, hyper, device)[0]


def _measure_cell(cfg: ArchConfig, shape: ShapeSpec, multi_pod: bool,
                  hyper: Optional[ts.TrainHyper], device: str,
                  cache_update: str = "dus",
                  replicate_params_over_data: bool = False):
    """`compile_cell`'s ``(record, stats)``, ``stats`` the call's
    `roofline.CollectiveStats` with each collective's site; a decode step
    writes its caches by ``cache_update``, and a serving step's
    parameters are replicated over "data" with
    ``replicate_params_over_data``, as `jit_decode_step` and
    `jit_prefill` take them."""
    n_chips = 512 if multi_pod else 256
    if shape.kind == "train":
        hyper = hyper or ts.TrainHyper(
            microbatches=default_microbatches(cfg, shape, multi_pod),
            compress_cross_pod=multi_pod)
    with _fake_group(n_chips):
        t0 = time.time()
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        step, args = _cell_step(cfg, shape, mesh, hyper, device,
                                cache_update, replicate_params_over_data)
        t_lower = time.time() - t0
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        out, coll, flops, t_compile, peak = _run_measured(step, args,
                                                          device)
        launches = _counts(_build.LAUNCHES, launches)
        plain = _counts(_build.PLAIN_CALLS, plain)
        arg_bytes = _arg_bytes(cfg, shape, args)
        out_bytes = _local_bytes(out)
        state_bytes = _state_bytes(shape, out)
        alias = _alias_bytes(args, out)
        del out, step, args

    temp = peak - (out_bytes - alias) if peak is not None else -1
    nm = hyper.microbatches if shape.kind == "train" else 1
    ana = rl.analytic_costs(cfg, shape, n_chips, microbatches=nm,
                            remat=(hyper.remat if shape.kind == "train"
                                   else "none"))
    coll_dev = coll.tpu_corrected_bytes
    terms = rl.roofline_terms(ana.flops_per_device,
                              ana.hbm_bytes_per_device, coll_dev,
                              model_flops_dev=ana.model_flops_global / n_chips)
    mem_dev = arg_bytes + max(temp, 0) + out_bytes - alias
    mf_dev = ana.model_flops_global / n_chips
    by_site: Dict[str, int] = {}
    for (kind, _, nbytes, _, _), site in zip(coll.calls, coll.sites):
        by_site[f"{kind} {site}"] = by_site.get(f"{kind} {site}", 0) + nbytes
    return {
        "arch": cfg.name, "shape": shape.name,
        "mesh": _mesh_name(multi_pod),
        "n_chips": n_chips,
        "status": "ok",
        "device": device,
        "lower_s": round(t_lower, 2), "compile_s": round(t_compile, 2),
        "kernel_launches": launches, "plain_calls": plain,
        "memory_analysis": {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(out_bytes),
            "state_bytes": int(state_bytes),
            "temp_bytes": int(temp),
            "alias_bytes": int(alias),
            "per_device_bytes": int(mem_dev),
            "fits_hbm": bool(mem_dev < HBM_BYTES),
        },
        "cost_analysis_raw": {
            "flops": float(flops),
            "bytes_accessed": -1.0,
            "note": "per-device; this rank's blocks, counted by "
                    "FlopCounterMode's formulas over the first call",
        },
        "collectives": {
            "total_bytes_per_device": int(coll.total_bytes),
            "tpu_corrected_bytes_per_device": int(coll.tpu_corrected_bytes),
            "by_kind": {k: int(v) for k, v in coll.by_kind.items() if v},
            "by_group_size": {str(k): int(v)
                              for k, v in coll.by_group_size.items()},
            "ops": coll.ops,
            "by_site": by_site,
        },
        "analytic": {
            "flops_per_device": ana.flops_per_device,
            "hbm_bytes_per_device": ana.hbm_bytes_per_device,
            "model_flops_global": ana.model_flops_global,
            "params_global": ana.params_global,
            "model_vs_hlo_flops": mf_dev / ana.flops_per_device,
            "microbatches": nm,
        },
        "roofline": terms,
    }, coll


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             device: str = "cuda", microbatches: Optional[int] = None
             ) -> Dict:
    """A cell's record (`compile_cell`), ``"skipped"`` with the JAX
    module's reason, or ``"error"`` with the exception.  A train cell
    runs at ``microbatches`` (default `default_microbatches`)."""
    cfg = get_config(arch)
    shape = SHAPE_BY_NAME[shape_name]
    reason = skip_reason(cfg, shape)
    if reason:
        return {"arch": cfg.name, "shape": shape.name,
                "mesh": _mesh_name(multi_pod),
                "status": "skipped", "reason": reason}
    hyper = None
    if microbatches and shape.kind == "train":
        hyper = ts.TrainHyper(microbatches=microbatches,
                              compress_cross_pod=multi_pod)
    try:
        return compile_cell(cfg, shape, multi_pod, hyper, device=device)
    except Exception as e:  # a failure here is a bug in the system
        return {"arch": cfg.name, "shape": shape.name,
                "mesh": _mesh_name(multi_pod),
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--device", default="cuda",
                    help="where the rank's blocks live (cuda or cpu)")
    ap.add_argument("--microbatches", type=int, default=None,
                    help="train cells' microbatches (default: "
                         "default_microbatches)")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = [s.name for s in SHAPES] if args.all or not args.shape \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    for mp in meshes:
        with _fake_group(512 if mp else 256):
            for arch in archs:
                for shape in shapes:
                    tag = f"{ALIASES.get(arch, arch)}_{shape}_" + \
                        ("multi" if mp else "single")
                    path = os.path.join(args.out, tag + ".json")
                    if os.path.exists(path):
                        print(f"[skip existing] {tag}")
                        continue
                    t0 = time.time()
                    res = run_cell(arch, shape, mp, device=args.device,
                                   microbatches=args.microbatches)
                    res["wall_s"] = round(time.time() - t0, 1)
                    with open(path, "w") as f:
                        json.dump(res, f, indent=1)
                    status = res["status"]
                    extra = ""
                    if status == "ok":
                        r = res["roofline"]
                        ma = res["memory_analysis"]
                        extra = (f" dominant={r['dominant']}"
                                 f" frac={r['roofline_fraction']:.2f}"
                                 f" mem/dev={ma['per_device_bytes']/2**30:.2f}GiB"
                                 f" args={ma['argument_bytes']}"
                                 f" compile={res['compile_s']:.0f}s"
                                 f" wall={res['wall_s']}s")
                    elif status == "error":
                        extra = " " + res["error"][:120]
                    print(f"[{status}] {tag}{extra}", flush=True)


if __name__ == "__main__":
    main()
