"""Per-mesh artifact cache for expensive init-time host computations.

A jax-free copy of meshopticalflow_tpu/utils/artifacts.py (tests/test_torch_host.py
pins the copied functions). Subdivision, operator assembly, coarse spaces and
symbolic analyses are cached on disk keyed by input-content hashes + config,
so a repeat construction of the same problem loads npz files instead of
recomputing them. Two changes from the reference: the key tag ``_VERSION``
is the port's own, so an npz one package wrote is never read by the other
under the same $MESHFLOW_CACHE, the JSON sidecars (pinned refinement
schedules, which the port does not have) are left out, and ``cached`` reads
and writes inside the spans ``artifact.read`` and ``artifact.write``
(utils/spans.py).

Layout: $MESHFLOW_CACHE (default ~/.cache/meshflow_artifacts)/<tag>-<key>.npz
Scipy CSR matrices are stored as <name>__{data,indices,indptr,shape}.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict

import numpy as np
import scipy.sparse as sp

from meshopticalflow_tpu_torch.utils import spans

# Bump when cached array semantics change.
_VERSION = "torch-r1"


def cache_dir() -> str:
    d = os.environ.get("MESHFLOW_CACHE",
                       os.path.join(os.path.expanduser("~"), ".cache",
                                    "meshflow_artifacts"))
    os.makedirs(d, exist_ok=True)
    return d


def file_hash(path: str) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()[:16]


def key_of(*parts) -> str:
    return hashlib.sha1(repr((_VERSION,) + parts).encode()).hexdigest()[:16]


def _flatten(d: Dict) -> Dict[str, np.ndarray]:
    out = {}
    for k, v in d.items():
        if sp.issparse(v):
            csr = sp.csr_matrix(v)
            out[f"{k}__data"] = csr.data
            out[f"{k}__indices"] = csr.indices
            out[f"{k}__indptr"] = csr.indptr
            out[f"{k}__shape"] = np.asarray(csr.shape)
        else:
            out[k] = np.asarray(v)
    return out


class LazyNpzArray:
    """A cache member materialized only on first use.

    Exposes ``__array__`` (so ``np.asarray`` / ``torch.as_tensor(np.asarray(.))``
    work transparently) and a header-only ``shape``/``dtype`` — consumers that
    only need metadata never touch the payload. Used for large FALLBACK
    blocks (the dense patch coarsest) that the production exact-coarse
    path never reads: skipping them cuts the coarse artifact load from
    ~350 MB to ~150 MB of disk traffic per problem construction."""

    def __init__(self, path: str, key: str):
        self._path = path
        self._key = key
        self._meta = None

    def _header(self):
        if self._meta is None:
            import zipfile

            with zipfile.ZipFile(self._path) as zf:
                with zf.open(self._key + ".npy") as f:
                    fmt = np.lib.format
                    version = fmt.read_magic(f)
                    if version == (1, 0):
                        shape, _, dtype = fmt.read_array_header_1_0(f)
                    elif version == (2, 0):
                        shape, _, dtype = fmt.read_array_header_2_0(f)
                    else:  # future format: private fallback
                        shape, _, dtype = fmt._read_array_header(f, version)
            self._meta = (shape, dtype)
        return self._meta

    @property
    def shape(self):
        return self._header()[0]

    @property
    def dtype(self):
        return self._header()[1]

    @property
    def ndim(self):
        return len(self.shape)

    def __array__(self, dtype=None, copy=None):
        with np.load(self._path, allow_pickle=False) as z:
            a = z[self._key]
        return a.astype(dtype) if dtype is not None else a


def _unflatten(z, path: str = "", lazy_keys=()) -> Dict:
    names = set(z.files)
    out: Dict = {}
    done = set()
    for name in names:
        if "__" in name:
            base = name.split("__")[0]
            if base in done:
                continue
            done.add(base)
            out[base] = sp.csr_matrix(
                (z[f"{base}__data"], z[f"{base}__indices"], z[f"{base}__indptr"]),
                shape=tuple(z[f"{base}__shape"]))
        elif name in lazy_keys and path:
            out[name] = LazyNpzArray(path, name)
        else:
            out[name] = z[name]
    return out


def cached(tag: str, key: str, compute: Callable[[], Dict],
           enabled: bool = True, lazy_keys=()) -> Dict:
    """Load {name: array-or-csr} from cache, or compute and store it.

    ``lazy_keys`` members come back as :class:`LazyNpzArray` on cache hits
    (payload read deferred to first ``np.asarray``); fresh computes return
    the real arrays."""
    if not enabled:
        return compute()
    path = os.path.join(cache_dir(), f"{tag}-{key}.npz")
    if os.path.exists(path):
        try:
            with spans.span("artifact.read"), np.load(path, allow_pickle=False) as z:
                return _unflatten(z, path=path, lazy_keys=lazy_keys)
        except Exception:
            pass  # corrupt/stale -> recompute
    out = compute()
    tmp = path + f".{os.getpid()}.tmp.npz"   # np.savez appends .npz otherwise
    with spans.span("artifact.write"):
        np.savez(tmp, **_flatten(out))
        os.replace(tmp, path)
    return out
