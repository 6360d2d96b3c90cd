"""Launch constants and ablations of the bulk-copy, grid-accumulation,
block-select, row-gather, scale and flat-gather probe kernels, on one
NVIDIA GPU.

    python3 probe_sweep.py

Every case is timed in turns with its yardstick (``x[a:b].clone()``;
``torch.sum(x, dim=1)``; block select's plain version, an index_select and
an add; ``torch.gather``; ``torch.mul``; ``torch.take``), as
``chip_smoke.py`` phase 3 times the configuration the port ships, at the
reference script's shapes, at the byte-bound sizes of
``chip_smoke.LARGE_PROBES`` and, for the flat gather, at a seeded random
permutation idx of the large size ("random"), where no order of the
outputs can save x's bytes:

- SWEEP: ``kernels/probes.py``'s ``BULK_*`` / ``ACC_*`` / ``TILE_*`` /
  ``SCALE_*`` / ``GATHER_*`` launch constants (the flat gather's chunk of
  1,024 / 4,096 / 16,384 outputs among them), each checked for exact
  equality with the plain version;
- ABLATIONS: kernels built from ``csrc/probes.cu`` with a part taken out or
  changed (into ``_build/``), which say where the time goes: the launch
  alone (bulk copy, block select, row gather), the bulk load alone and a
  4-stage ring (bulk copy), block select through a TMA-staged tile in
  shared memory, row gather without its one-row float4 fast path, scale
  with plain loads and stores in place of its streaming cache hints
  (``__ldcs`` / ``__stcs``), the flat gather in t
  order (no ordering pass) and walking the order grid-stride (each CTA
  not a contiguous run of it), and the four kernels' earlier designs (one CTA per
  selected block; one thread per gathered float; one thread per scaled
  float; one thread per flat-gathered float, in t order);
- ORDER: the flat gather's ordering pass alone, in turns with its plain
  twin (a stable torch.sort), at the large and the random idx.

Prints one line per case and writes ``chiprun_out/probe_sweep.json``.
"""

from __future__ import annotations

import json
import os
import sys

import chip_smoke as smoke

DMA, ACC = "manual HBM->VMEM DMA", "grid accumulation"
SEL, ROW = "scalar-prefetch index_map", "take_along_axis rows (axis 0)"
BASIC, FLAT = "basic", "flat 1-D gather"
T_ORDER = dict(GATHER_MIN_ORDERED_CHUNKS=10 ** 9)       # no ordering pass
# (probe, size, {constant: value})
SWEEP = ([(DMA, "script", dict(BULK_MIN_CHUNK=c)) for c in (64, 128, 256, 512, 1024, 4096)]
         + [(DMA, "large", dict(BULK_CTAS_PER_SM=k, BULK_MAX_CHUNK=c)) for k, c in
            ((2, 4096), (4, 4096), (6, 4096), (4, 2048), (8, 2048), (12, 1024))]
         + [(ACC, "script", dict(ACC_MIN_THREADS=t)) for t in (32, 64, 128)]
         + [(ACC, "large", dict(ACC_THREADS=t, ACC_CTAS_PER_SM=k)) for t, k in
            ((128, 16), (128, 32), (128, 64), (256, 32), (128, 10 ** 6))]
         + [(p, "script", dict(TILE_MIN_THREADS=t, TILE_VPT=v)) for p in (SEL, ROW)
            for t, v in ((32, 1), (32, 2), (32, 4), (64, 4), (128, 4), (32, 8))]
         + [(p, "large", dict(TILE_THREADS=t, TILE_VPT=v, TILE_CTAS_PER_SM=k))
            for p in (SEL, ROW)
            for t, v, k in ((128, 4, 16), (128, 4, 8), (128, 4, 32), (128, 2, 16),
                            (128, 8, 16), (256, 4, 8), (256, 2, 16), (128, 4, 10 ** 6))]
         + [(BASIC, "script", dict(SCALE_THREADS=t)) for t in (64, 128, 256, 512)]
         + [(BASIC, "large", dict(SCALE_THREADS=t, SCALE_VPT=v, SCALE_CTAS_PER_SM=k))
            for t, v, k in ((256, 4, 32), (256, 4, 64), (256, 4, 128), (128, 4, 128),
                            (128, 2, 10 ** 6))]
         + [(FLAT, "script", dict(GATHER_MIN_THREADS=t)) for t in (32, 128)]
         + [(FLAT, size, dict(GATHER_CHUNK=c)) for size in ("large", "random")
            for c in (1024, 2048, 4096, 8192)]
         + [(FLAT, "large", dict(GATHER_THREADS=t, GATHER_VPT=v, GATHER_CTAS_PER_SM=k))
            for t, v, k in ((1024, 1, 1), (512, 2, 1), (256, 4, 1), (1024, 1, 2), (512, 2, 2),
                            (128, 4, 32))])

_STORE = '''    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(dst + c * chunk), "r"(ring_addr + s * stage_bytes),
                    "r"(chunk_bytes(c))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
'''
_HEAD = "  extern __shared__ __align__(128) float ring[];\n"
_SEL_HEAD = "  const int64_t tile = static_cast<int64_t>(VPT) * blockDim.x;\n  for (int64_t t = "
_ROW_HEAD = "  constexpr int kWidth = sizeof(T) / sizeof(float);\n"
# Block select with the tile staged through shared memory by the TMA, the
# literal form of an index map driving a DMA: one CTA a tile (no grid
# stride), sel read by the issuing thread, a 1-D bulk load on an expect_tx
# mbarrier, +1 by the threads, a proxy fence, a 1-D bulk store. Vector
# form only (16-byte aligned tiles).
_SEL_TMA_KERNEL = r'''
__global__ void probe_block_select_tma_kernel(const float* __restrict__ x,
                                              const int32_t* __restrict__ sel,
                                              float* __restrict__ o, int64_t block_elems,
                                              int tile, int tiles_per_block) {
  extern __shared__ __align__(128) float buf[];
  __shared__ __align__(8) uint64_t full;
  const int64_t b = blockIdx.x / tiles_per_block;
  const int64_t first = (blockIdx.x - b * tiles_per_block) * static_cast<int64_t>(tile);
  const int64_t rem = block_elems - first;
  const uint32_t bytes = static_cast<uint32_t>(rem < tile ? rem : tile) * 4u;
  const uint32_t bar = smem_addr(&full);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_addr(buf)), "l"(x + static_cast<int64_t>(sel[b]) * block_elems + first),
           "r"(bytes), "r"(bar)
        : "memory");
  }
  __syncthreads();
  wait_parity(bar, 0);
  float4* v = reinterpret_cast<float4*>(buf);
  for (uint32_t e = threadIdx.x; e < bytes / 16u; e += blockDim.x) v[e] = plus_one(v[e]);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(o + b * block_elems + first), "r"(smem_addr(buf)), "r"(bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

'''
_SEL_TMA_LAUNCH = """      probe_block_select_tma_kernel<<<nsel * tiles_per_block, threads,
                                      vpt * threads * 16, st>>>(
          static_cast<const float*>(x), s, static_cast<float*>(o), block_units * 4,
          vpt * threads * 4, tiles_per_block);
"""
# The earlier designs of four kernels: one CTA of 256 threads per selected
# block walking it with 4-byte loads and stores; one thread per gathered
# float, its lane from a 64-bit remainder; one thread per scaled float; one
# thread per flat-gathered float in t order (run with T_ORDER, so no
# ordering pass either). Each takes the vector form's operands.
_EARLIER_KERNELS = r'''
__global__ void probe_block_select_cta_kernel(const float* __restrict__ x,
                                              const int32_t* __restrict__ sel,
                                              float* __restrict__ o, int64_t block_elems) {
  const float* src = x + static_cast<int64_t>(sel[blockIdx.x]) * block_elems;
  float* dst = o + static_cast<int64_t>(blockIdx.x) * block_elems;
  for (int64_t e = threadIdx.x; e < block_elems; e += blockDim.x) dst[e] = src[e] + 1.0f;
}

__global__ void probe_row_gather_float_kernel(const float* __restrict__ x,
                                              const int32_t* __restrict__ idx,
                                              float* __restrict__ o, int64_t mw, int w) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < mw) o[t] = x[static_cast<int64_t>(idx[t]) * w + static_cast<int>(t % w)];
}

__global__ void probe_scale_float_kernel(const float* __restrict__ x, float* __restrict__ o,
                                         int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) o[i] = 2.0f * x[i];
}

__global__ void probe_flat_gather_float_kernel(const float* __restrict__ x,
                                               const int32_t* __restrict__ idx,
                                               float* __restrict__ o, int64_t n) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < n) o[t] = x[idx[t]];
}

'''
_LAST_ERROR = "int last_error() {"
# the flat gather's walk: each CTA a contiguous run of tile steps (shipped),
# or steps blockIdx.x, blockIdx.x + grid, ... (grid-stride, so neighbouring
# positions of the order run on different SMs at once and share x in L2)
_GATHER_RUNS = "  for (int64_t s = blockIdx.x * per; s < stop; ++s) {\n"
_GATHER_STRIDE = "  for (int64_t s = blockIdx.x; s < n_steps; s += gridDim.x) {\n"
_SCALE_HEAD = ("                                   int tail) {\n"
               "  const int64_t tile = static_cast<int64_t>(VPT) * blockDim.x;\n")
_FLAT_HEAD = "                                         int64_t n_steps, int64_t per, int tail) {\n"
_SIZES = ("script", "large")
# name -> ((old, new) text replacements in csrc/probes.cu, constants, exact?,
#          probes timed, sizes)
ABLATIONS = {
    "launch_only": ([(_HEAD, "  return;\n" + _HEAD), (_SEL_HEAD, "  return;\n" + _SEL_HEAD),
                     (_ROW_HEAD, _ROW_HEAD + "  return;\n"),
                     (_SCALE_HEAD, _SCALE_HEAD.replace("{\n", "{\n  return;\n", 1)),
                     (_FLAT_HEAD, _FLAT_HEAD + "  return;\n")], {}, False,
                    (DMA, SEL, ROW, BASIC, FLAT), _SIZES),
    "load_only": ([(_STORE, "")], {}, False, (DMA,), _SIZES),
    # 4 stages of 8 KB, two stores in flight before a stage is refilled
    "ring4": ([("uint64_t full[2];", "uint64_t full[4];"),
               ("for (int s = 0; s < 2; ++s) {", "for (int s = 0; s < 4; ++s) {"),
               ("const int s = j & 1;", "const int s = j & 3;"),
               ("static_cast<uint32_t>(j >> 1) & 1u", "static_cast<uint32_t>(j >> 2) & 1u"),
               ('asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");\n      '
                "load(c + 2 * step, s);",
                'asm volatile("cp.async.bulk.wait_group.read 2;" ::: "memory");\n      '
                "load(c + 2 * step, (j + 2) & 3);"),
               ("<<<grid, 32, smem,", "<<<grid, 32, 2 * smem,")],
              dict(BULK_MAX_CHUNK=2048, BULK_CTAS_PER_SM=8), True, (DMA,), _SIZES),
    "select_tma": ([(_LAST_ERROR, _SEL_TMA_KERNEL + _LAST_ERROR),
                    ("      PROBE_VPT_SWITCH(vpt, PROBE_SELECT_VECTOR)\n", _SEL_TMA_LAUNCH)],
                   {}, True, (SEL,), _SIZES),
    "gather_no_fast_path": ([("if (row.x == row.y && row.x == row.z && row.x == row.w) {",
                              "if (false) {")], {}, True, (ROW,), _SIZES),
    "scale_cached": ([("if (u < units) val[v] = __ldcs(x + u);",
                       "if (u < units) val[v] = __ldg(x + u);"),
                      ("if (u < units) __stcs(o + u, twice(val[v]));",
                       "if (u < units) o[u] = twice(val[v]);")],
                     {}, True, (BASIC,), _SIZES),
    "gather_t_order": ([], T_ORDER, True, (FLAT,), ("large", "random")),
    "gather_strided": ([(_GATHER_RUNS, _GATHER_STRIDE)], {}, True, (FLAT,),
                       ("large", "random")),
    "gather_strided_narrow": ([(_GATHER_RUNS, _GATHER_STRIDE)],
                              dict(GATHER_THREADS=128, GATHER_VPT=4, GATHER_CTAS_PER_SM=32),
                              True, (FLAT,), ("large",)),
    "earlier_designs": ([(_LAST_ERROR, _EARLIER_KERNELS + _LAST_ERROR),
                         ("      PROBE_VPT_SWITCH(vpt, PROBE_SELECT_VECTOR)\n",
                          "      probe_block_select_cta_kernel<<<nsel, kThreads, 0, st>>>(\n"
                          "          static_cast<const float*>(x), s, static_cast<float*>(o),"
                          " block_units * 4);\n"),
                         ("      PROBE_VPT_SWITCH(vpt, PROBE_ROW_GATHER_VECTOR)\n",
                          "      probe_row_gather_float_kernel<<<blocks_for(units * 4), kThreads,"
                          " 0, st>>>(\n          xf, static_cast<const int32_t*>(idx),"
                          " static_cast<float*>(o), units * 4, w);\n"),
                         ("      PROBE_VPT_SWITCH(vpt, PROBE_SCALE_VECTOR)\n",
                          "      probe_scale_float_kernel<<<blocks_for(units * 4 + tail), kThreads,"
                          " 0, st>>>(\n          static_cast<const float*>(x),"
                          " static_cast<float*>(o), units * 4 + tail);\n"),
                         ("      PROBE_VPT_SWITCH(vpt, PROBE_FLAT_VECTOR)\n",
                          "      probe_flat_gather_float_kernel<<<blocks_for(units * 4 + tail),"
                          " kThreads, 0, st>>>(\n          xf, static_cast<const int32_t*>(idx),"
                          " static_cast<float*>(o), units * 4 + tail);\n")],
                        T_ORDER, True, (SEL, ROW, BASIC, FLAT), _SIZES),
}


def random_flat_args():
    """The flat gather's large x with idx a random permutation of its
    indices (torch.Generator seeded 0, on the card)."""
    import torch

    x, idx = smoke.large_probe_args(FLAT)
    gen = torch.Generator(device=smoke.DEVICE).manual_seed(0)
    perm = torch.randperm(idx.numel(), generator=gen, device=smoke.DEVICE)
    return x, perm.to(torch.int32).view(idx.shape)


def ablated_library(probes, build, name: str):
    """csrc/probes.cu with ABLATIONS[name]'s replacements, as a library."""
    src = (build.CSRC / "probes.cu").read_text()
    for old, new in ABLATIONS[name][0]:
        if src.count(old) != 1:
            raise RuntimeError(f"ablation {name}: {old[:60]!r} is not in csrc/probes.cu once")
        src = src.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / f"probes_{name}.cu"
    path.write_text(src)
    return build.CudaLibrary(f"probes_{name}", str(path), probes._bind)


def _case(probes, probe: str, size: str, consts: dict, exact: bool = True) -> dict:
    import torch

    _, _, kernel, builder = next(p for p in probes.PROBES if p[0] == probe)
    saved = {k: getattr(probes, k) for k in consts}
    for k, v in consts.items():
        setattr(probes, k, v)
    probes.clear_plans()
    try:
        args = (probes.probe_args(builder, torch.device(smoke.DEVICE))[0] if size == "script"
                else random_flat_args() if size == "random" else smoke.large_probe_args(probe))
        if exact and not torch.equal(kernel(*args), probes.PLAINS[kernel](*args)):
            raise RuntimeError(f"{probe} {consts}: kernel and plain differ")
        return smoke.yardstick_turns(probes, probe, kernel, args,
                                     "large" if size == "random" else size)
    finally:
        for k, v in saved.items():
            setattr(probes, k, v)
        probes.clear_plans()
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_sweep: torch.cuda.is_available() is false")
    sys.path.insert(0, smoke.REPO)
    from meshopticalflow_tpu_torch.kernels import build, probes

    print(smoke.card_line(), flush=True)
    shipped = probes.LIBRARY
    ablated = {name: ablated_library(probes, build, name) for name in ABLATIONS}
    build.build_all([shipped, *ablated.values()])
    out = []
    for probe, size, consts in SWEEP:
        print(f"sweep {probe} {size} {consts}:", flush=True)
        out.append(dict(probe=probe, size=size, constants=consts,
                        **_case(probes, probe, size, consts)))
    for name, (_, consts, exact, timed, sizes) in ABLATIONS.items():
        probes.LIBRARY = ablated[name]
        try:
            for probe in timed:
                for size in sizes:
                    print(f"ablation {name} {probe} {size} {consts}:", flush=True)
                    out.append(dict(probe=probe, size=size, ablation=name, constants=consts,
                                    **_case(probes, probe, size, consts, exact)))
        finally:
            probes.LIBRARY = shipped
    for size in ("large", "random"):
        print(f"ordering pass alone, {size} idx:", flush=True)
        args = random_flat_args() if size == "random" else smoke.large_probe_args(FLAT)
        out.append(dict(probe=FLAT, size=size, ablation="order_alone",
                        **smoke.order_check(probes, args[1])))
        del args
        torch.cuda.empty_cache()
    with open(os.path.join(os.path.dirname(smoke.WORK), "probe_sweep.json"), "w") as f:
        json.dump(dict(card=smoke.card_line(), cases=out), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
