"""Process-level cache of built device state (uploaded tensors, solver
handles) keyed by the problem's artifact identity.

A rewrite of meshopticalflow_tpu/utils/devcache.py for torch. The disk
artifact cache (utils/artifacts.py) amortizes host work across processes;
this cache amortizes, within one process, the cost of turning those
artifacts back into device state: npz reads, host-to-device copies and the
solvers' static operators. A user aligning many pairs over one mesh
(apps/track_sequence.py, ``--serve`` jobs) pays that once per mesh.

FlowProblem construction registers its device state (basis tensors,
hierarchy handles, texel tables, textures, preprocessed signals,
multifrontal index tables) under the same keys the disk cache uses, and
later constructions of the same problem reuse the resident tensors. Torch
tensors are mutable, so every consumer of cached state works out of place
(``shift_diag``, the texel remap, the system assemblies); handles whose
state accumulates on purpose (the MG packs' contraction estimates) are
copied per problem, so a warm construction computes what a cold one does.

Keys: the entry's key tuple prefixed by ``str(device)`` of the tensors it
holds. A falsy key bypasses the cache. The cache is LRU-bounded by entries
and by bytes ($MESHFLOW_DEVCACHE_GB, default 4), and MESHFLOW_DEVCACHE=0
disables it.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Callable

_CACHE: "OrderedDict[tuple, Any]" = OrderedDict()
_SIZES: dict = {}
_MAX_ENTRIES = 24
# Device memory is the budget: a few 2K-atlas entries (textures, texel
# tables, hierarchy handles) would otherwise pin GBs in a long --serve or
# track_sequence process that visits many meshes.
_MAX_BYTES = int(float(os.environ.get(
    "MESHFLOW_DEVCACHE_GB", "4.0")) * (1 << 30))


def enabled() -> bool:
    return os.environ.get("MESHFLOW_DEVCACHE", "1").strip() not in (
        "0", "off", "no")


def _entry_nbytes(value, _depth=0) -> int:
    """Best-effort byte accounting: walk containers and handle objects one
    structural layer at a time and sum ``.nbytes`` of tensor and array
    leaves (``torch.Tensor.nbytes``, ``np.ndarray.nbytes``)."""
    if _depth > 4:
        return 0
    nb = getattr(value, "nbytes", None)
    if isinstance(nb, int):
        return nb
    if isinstance(value, dict):
        items = value.values()
    elif isinstance(value, (tuple, list)):
        items = value
    elif hasattr(value, "__dict__"):
        items = vars(value).values()
    else:
        return 0
    return sum(_entry_nbytes(v, _depth + 1) for v in items)


def get_or_build(key: tuple, build: Callable[[], Any], device="cpu") -> Any:
    """Return the cached value for ``key`` on ``device`` or build and
    register it. ``key`` must capture everything that shapes the value
    (artifact key, dtype, config); a falsy key bypasses the cache."""
    if not key or not enabled():
        return build()
    key = (str(device),) + tuple(key)
    if key in _CACHE:
        _CACHE.move_to_end(key)
        return _CACHE[key]
    value = build()
    _CACHE[key] = value
    _SIZES[key] = _entry_nbytes(value)
    while len(_CACHE) > 1 and (
            len(_CACHE) > _MAX_ENTRIES
            or sum(_SIZES.values()) > _MAX_BYTES):
        old, _ = _CACHE.popitem(last=False)
        _SIZES.pop(old, None)
    return value


def total_bytes() -> int:
    return sum(_SIZES.values())


def clear() -> None:
    _CACHE.clear()
    _SIZES.clear()
