"""The leaf-name convention of `repro.distributed.sharding` that
checkpoints share with the JAX package (`path_str`).  The mesh rules and
shardings wait for the multi-card slice (ROADMAP.md)."""

from __future__ import annotations

__all__ = ["path_str"]


def path_str(path) -> str:
    """``"/"``-joined key path: a part with a ``key`` (a dict key) or an
    ``idx`` (a sequence index) gives that, any other part its ``str`` (a
    named-tuple field is ``".name"``, as JAX's ``GetAttrKey`` prints)."""
    parts = []
    for k in path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return "/".join(parts)
