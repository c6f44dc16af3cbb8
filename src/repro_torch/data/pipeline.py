"""Deterministic, resumable synthetic data pipeline.  The port of
`repro.data.pipeline` (numpy, unchanged: batches equal the JAX package's
bit for bit).

Produces next-token-prediction batches from a seeded synthetic token stream
(a mixture of Zipf-distributed unigrams and repeated n-gram motifs, so the
loss actually decreases during the example runs).  Every batch is a pure
function of ``(seed, step)`` — restart/elastic-resume needs no iterator
state, only the step counter from the checkpoint (fault-tolerance story:
DESIGN.md).

The host-staging buffers are allocated from a **colored staging pool**
(`ColoredStagingPool`) — the CAP consumer: the pool's arena zones map
to CacheX virtual colors on the host side / HBM arena zones on device, and
the allocator follows CAP's hottest-first policy fed by the monitor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.cap import CapAllocator

__all__ = ["DataConfig", "synth_tokens", "make_batch", "ColoredStagingPool",
           "DataIterator"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    motif_len: int = 16
    n_motifs: int = 64
    zipf_a: float = 1.3


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng((cfg.seed, step))


def synth_tokens(cfg: DataConfig, step: int, batch: int, seq: int,
                 vocab: int) -> np.ndarray:
    """(batch, seq+1) int32 tokens: zipf background + motif insertions."""
    rng = _batch_rng(cfg, step)
    toks = rng.zipf(cfg.zipf_a, size=(batch, seq + 1)).astype(np.int64)
    toks = (toks - 1) % max(2, vocab // 4)
    motif_rng = np.random.default_rng(cfg.seed)  # motifs fixed across steps
    motifs = motif_rng.integers(0, vocab, size=(cfg.n_motifs, cfg.motif_len))
    n_insert = max(1, seq // (4 * cfg.motif_len))
    for b in range(batch):
        for _ in range(n_insert):
            m = motifs[rng.integers(cfg.n_motifs)]
            p = rng.integers(0, seq + 1 - cfg.motif_len)
            toks[b, p:p + cfg.motif_len] = m
    return toks.astype(np.int32)


def make_batch(cfg: DataConfig, arch: ArchConfig, shape: ShapeSpec,
               step: int) -> Dict[str, np.ndarray]:
    """Global batch for one step (numpy; the caller moves it to its device)."""
    B, S = shape.global_batch, shape.seq_len
    rng = _batch_rng(cfg, step)
    if arch.family == "encoder":
        frames = rng.standard_normal((B, S, arch.d_input_stub),
                                     dtype=np.float32)
        targets = rng.integers(0, arch.vocab, size=(B, S)).astype(np.int32)
        return {"frames": frames.astype(np.float32), "targets": targets}
    if arch.family == "vlm":
        s_img = arch.stub_seq
        toks = synth_tokens(cfg, step, B, S - s_img, arch.vocab)
        patches = rng.standard_normal((B, s_img, arch.d_input_stub),
                                      dtype=np.float32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
                "patch_embeds": patches}
    toks = synth_tokens(cfg, step, B, S, arch.vocab)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class ColoredStagingPool:
    """Host staging buffers drawn from CAP-colored zones.

    The CAP analogue of page-cache coloring: streaming input staging is
    the lowest-locality traffic in the system, so its buffers are placed in
    the arena zone the monitor reports as hottest — absorbing interference
    instead of spreading it (paper §4.2 applied to the data path).
    """

    def __init__(self, n_zones: int = 8, bufs_per_zone: int = 16,
                 buf_bytes: int = 1 << 20):
        lists = {z: [(z, i) for i in range(bufs_per_zone)]
                 for z in range(n_zones)}
        self.cap = CapAllocator(lists)
        self.buf_bytes = buf_bytes
        self._backing: Dict = {}

    @classmethod
    def from_colors(cls, colors_view, bufs_per_zone: int = 16,
                    buf_bytes: int = 1 << 20) -> "ColoredStagingPool":
        """Build the pool over a session's probed zone map — e.g. the pod
        session's ``PodColorsView`` VMEM/HBM arena zones (anything whose
        ``build_free_lists(per_zone)`` returns zone → buffer handles)."""
        pool = cls.__new__(cls)
        pool.cap = CapAllocator(colors_view.build_free_lists(bufs_per_zone))
        pool.buf_bytes = buf_bytes
        pool._backing = {}
        return pool

    def update_contention(self, per_zone_rate: Dict[int, float]) -> None:
        self.cap.step_interval(per_zone_rate)

    def on_contention(self, view) -> None:
        """`CacheXSession.subscribe` hook: follow the published per-color
        (per-zone) contention instead of being hand-fed rates."""
        self.update_contention(dict(view.per_color))

    def stage(self, arr: np.ndarray):
        """'Place' an array into a colored staging buffer (bookkeeping —
        real placement happens via the device allocator)."""
        handle = self.cap.allocate()
        if handle is None:            # pool exhausted: recycle oldest
            self.cap.reclaim_all()
            handle = self.cap.allocate()
        self._backing[handle] = arr
        return handle

    def release(self, handle) -> None:
        self._backing.pop(handle, None)
        # only return the buffer if CAP still tracks it as allocated (a
        # recolor event may have reclaimed it already)
        if handle in self.cap.allocated_pages:
            self.cap.allocated_pages.remove(handle)
            color = self.cap.page_color[handle]
            self.cap.free_lists[color].append(handle)


class DataIterator:
    """Stateless-resumable iterator bound to (arch, shape)."""

    def __init__(self, cfg: DataConfig, arch: ArchConfig, shape: ShapeSpec,
                 start_step: int = 0,
                 staging: Optional[ColoredStagingPool] = None):
        self.cfg, self.arch, self.shape = cfg, arch, shape
        self.step = start_step
        self.staging = staging

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        batch = make_batch(self.cfg, self.arch, self.shape, self.step)
        if self.staging is not None:
            for v in batch.values():
                self.staging.stage(v)
        self.step += 1
        return batch
