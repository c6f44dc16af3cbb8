"""Workers of the port's multi-process gloo tests.  They import neither
JAX nor the JAX package, so a spawned rank starts in the time torch
takes to import."""

import multiprocessing
import queue
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import _build
from repro_torch.configs import base as tbase
from repro_torch.distributed import elastic, sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline
from repro_torch.models import lm
from repro_torch.optim import adamw
from repro_torch._tree import tree_flatten_with_path
from repro_torch.train import train_step as ts
from tests.torch_goldens import sharded_variant_config


def restore_worker(rank, world, store, ckpt_root, step, jobs, out):
    """One rank of a ``(world // 2, 2)`` ("data", "model") gloo mesh: each
    reduced ``(arch, compress_cross_pod)`` checkpoint of ``jobs`` under
    ``ckpt_root/arch`` restored onto it, put on ``out`` as ``(rank,
    {"coords": ..., arch: {path: (type, device, placements, local)}})``,
    or ``(rank, repr(error))``."""
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        mesh = tmesh.make_host_mesh(model=2)
        res = {"coords": list(mesh.get_coordinate())}
        for arch, compress in jobs:
            cfg = tbase.reduced_config(tbase.get_config(arch))
            state = elastic.restore_on_mesh(
                f"{ckpt_root}/{arch}", step, cfg,
                ts.TrainHyper(compress_cross_pod=compress), mesh)
            res[arch] = {
                sharding.path_str(p): (type(x).__name__, x.device.type,
                                       list(x.placements),
                                       x.to_local().numpy())
                for p, x in tree_flatten_with_path(state)}
        dist.destroy_process_group()
        out.put((rank, res))
    except Exception as e:  # report to the parent, which fails the test
        out.put((rank, repr(e)))


def _numpy(tree):
    """{path: numpy} of a tree of full tensors."""
    return {sharding.path_str(p): x.detach().numpy()
            for p, x in tree_flatten_with_path(tree)}


def _misplaced(tree, shardings):
    """Paths of the leaves of ``tree`` whose type or placements are not
    the DTensor placements ``shardings`` names."""
    want = dict(tree_flatten_with_path(shardings))
    return [sharding.path_str(p) for p, x in tree_flatten_with_path(tree)
            if type(x).__name__ != "DTensor"
            or list(x.placements) != list(want[p])]


def _train_state(job):
    """The port's train state of a job's JAX state (numpy leaves)."""
    return ts.TrainState(
        params=lm.params_from_numpy(job["params"], "cpu"),
        opt=adamw.AdamWState(step=torch.as_tensor(job["step"]),
                             mu=lm.params_from_numpy(job["mu"], "cpu"),
                             nu=lm.params_from_numpy(job["nu"], "cpu")),
        ef=None)


def _hyper(job):
    return ts.TrainHyper(microbatches=job["nm"],
                         sequence_parallel=job["sp"],
                         remat=job.get("remat", "none"),
                         compute_dtype=torch.float32,
                         moe_impl=job["moe_impl"])


def _config(job):
    """The job's reduced config, as its ``variant`` (a `SHARDED_VARIANTS`
    case, or none) changes it."""
    return sharded_variant_config(
        tbase.reduced_config(tbase.get_config(job["arch"])),
        job.get("variant", ""))


def _train_job(job, mesh):
    """One `jit_train_step`; with ``job["count"]`` under
    `roofline.count_collectives` (the step places its full inputs without
    communication, so only its own collectives count)."""
    cfg = _config(job)
    hyper = _hyper(job)
    seq, batch = job["shape"]
    step, _, st_shard, _ = ts.jit_train_step(
        cfg, mesh, hyper, tbase.ShapeSpec("sharded", seq, batch, "train"))
    args = (_train_state(job), {k: torch.as_tensor(v)
                                for k, v in job["batch"].items()})
    stats = None
    if job.get("count"):
        (new, metrics), stats = roofline.count_collectives(step, *args)
    else:
        new, metrics = step(*args)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "misplaced": _misplaced(new, st_shard), "stats": stats,
            "params": {sharding.path_str(p): (tuple(x.shape),
                                              list(x.placements))
                       for p, x in tree_flatten_with_path(new.params)},
            "state": _numpy(sharding.gather_tree(new))}


def _serve_job(job, mesh):
    """`jit_prefill` with each ``impl`` of ``job["impls"]`` (default "ref"
    and "kernel"; on CPU blocks the kernel's wrapper runs its plain
    version, and counts it), then ``len(job["decode"])`` `jit_decode_step`
    calls from empty caches, with each cache write of ``job["updates"]``
    (default "dus", then "blend": the ``_blend`` keys); with
    ``job["replparams"]`` the parameters replicated over "data"."""
    cfg = _config(job)
    seq, batch = job["shape"]
    repl = job.get("replparams", False)
    params = lm.params_from_numpy(job["params"], "cpu")
    res = {"prefill": {}}
    for impl in job.get("impls", ("ref", "kernel")):
        plain = dict(_build.PLAIN_CALLS)
        prefill, _, (pshard, _) = ts.jit_prefill(
            cfg, mesh, tbase.ShapeSpec("sharded", seq, batch, "prefill"),
            torch.float32, impl, replicate_params_over_data=repl)
        res["data_split_params"] = _split_over_data(pshard)
        logits = prefill(params, {"tokens": torch.as_tensor(
            job["batch"]["tokens"])})
        res["prefill"][impl] = {
            "type": type(logits).__name__,
            "logits": logits.full_tensor().numpy(),
            "plain_calls": {k: _build.PLAIN_CALLS[k] - plain.get(k, 0)
                            for k in ("flash_attention", "ssd_scan")}}
    for update in job.get("updates", ("dus", "blend")):
        key = "_blend" if update == "blend" else ""
        decode, _, _, (pshard, cshard, _) = ts.jit_decode_step(
            cfg, mesh, tbase.ShapeSpec("sharded", seq, batch, "decode"),
            torch.float32, update, replicate_params_over_data=repl)
        res["data_split_params"] = _split_over_data(pshard)
        caches = lm.init_caches(cfg, batch, seq, torch.float32, device="cpu")
        res["decode" + key] = []
        for pos, tokens in enumerate(job["decode"]):
            logits, caches = decode(params, caches, torch.as_tensor(tokens),
                                    pos)
            res["decode" + key].append(logits.full_tensor().numpy())
        res["cache_misplaced" + key] = _misplaced(caches, cshard)
        res["cache_placements" + key] = {
            sharding.path_str(p): list(x.placements)
            for p, x in tree_flatten_with_path(caches)}
        res["caches" + key] = _numpy(sharding.gather_tree(caches))
    return res


def _split_over_data(pshard):
    """The paths of the parameters placed split over the "data" mesh dim
    (mesh dim 0) by placement tree ``pshard``."""
    return sorted(sharding.path_str(p) for p, pl in
                  tree_flatten_with_path(pshard) if pl[0].is_shard())


def _compress_job(job, mesh):
    """`jit_train_step` with ``compress_cross_pod`` and ``cast_params_once``
    against the same step without a mesh, both on the port (the gradients
    reach AdamW and the int8 compression as DTensors placed like their
    parameters)."""
    cfg = tbase.reduced_config(tbase.get_config(job["arch"]))
    hyper = ts.TrainHyper(microbatches=job["nm"], compress_cross_pod=True,
                          cast_params_once=True, remat="none",
                          compute_dtype=torch.float32)
    seq, batch = job["shape"]
    step, _, st_shard, _ = ts.jit_train_step(
        cfg, mesh, hyper, tbase.ShapeSpec("sharded", seq, batch, "train"))
    state = ts.make_train_state(cfg, hyper, 0, device="cpu")
    tb = {k: torch.as_tensor(v) for k, v in job["batch"].items()}
    new, metrics = step(state, tb)
    want, wm = ts.build_train_step(cfg, hyper)(state, tb)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "unsharded": {k: float(v) for k, v in wm.items()},
            "misplaced": _misplaced(new, st_shard),
            "state": _numpy(sharding.gather_tree(new)),
            "unsharded_state": _numpy(want)}


_JOBS = {"train": _train_job, "serve": _serve_job,
         "compress": _compress_job}


def sharded_step_worker(rank, world, store, inbox, out):
    """One rank of a ``(world // 2, 2)`` ("data", "model") gloo mesh
    running each job of the list it takes from ``inbox`` (dicts with a
    ``kind`` of `_JOBS` and a ``name``; the parent sends them once the
    ranks have started), in order: puts ``(rank, {name: result})`` on
    ``out``, or ``(rank, traceback)``.  Full tensors are gathered on every
    rank (a collective) and kept by rank 0 only.  Each rank computes on
    one thread: the work is small, and four ranks of torch's default
    thread count would take the cores the other tests of a parallel run
    need."""
    try:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=world, rank=rank)
        mesh = tmesh.make_host_mesh(model=2)
        jobs = inbox.get()
        res = {}
        for job in jobs:
            t0 = time.perf_counter()
            r = _JOBS[job["kind"]](job, mesh)
            r["seconds"] = time.perf_counter() - t0
            if rank:
                r = {k: v for k, v in r.items()
                     if k in ("misplaced", "cache_misplaced",
                              "cache_misplaced_blend", "metrics",
                              "unsharded", "seconds",
                              "data_split_params")}
            res[job["name"]] = r
        dist.destroy_process_group()
        out.put((rank, res))
    except Exception:  # report to the parent, which fails the test
        out.put((rank, traceback.format_exc()))


class Ranks:
    """``world`` spawned processes running ``target(rank, world, store,
    *args, out)``, or with ``inbox`` ``target(rank, world, store, *args,
    inbox, out)`` (`send` puts one object there for each rank); `collect`
    waits for each rank's ``(rank, result)``."""

    def __init__(self, target, store, *args, world=4, inbox=False):
        ctx = multiprocessing.get_context("spawn")
        self.out, self.world = ctx.Queue(), world
        self.inbox = ctx.Queue() if inbox else None
        extra = (self.inbox,) if inbox else ()
        self.procs = [ctx.Process(target=target,
                                  args=(r, world, store) + args + extra
                                  + (self.out,))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def send(self, obj) -> None:
        """``obj`` to every rank's ``inbox``."""
        for _ in range(self.world):
            self.inbox.put(obj)

    def collect(self, timeout: float) -> dict:
        """{rank: result} of every rank that answered within ``timeout``
        seconds each; every process is joined (or killed) before it
        returns."""
        got = {}
        try:
            for _ in range(self.world):
                rank, res = self.out.get(timeout=timeout)
                got[rank] = res
        except queue.Empty:
            pass
        finally:
            for p in self.procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        return got
