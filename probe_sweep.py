"""Launch constants and ablations of the bulk-copy and grid-accumulation
probe kernels, on one NVIDIA GPU.

    python3 probe_sweep.py

Every case is timed in turns with its one-call yardstick
(``x[a:b].clone()``; ``torch.sum(x, dim=1)``), as ``chip_smoke.py`` phase 3
times the configuration the port ships, at the reference script's shapes
and at the byte-bound sizes of ``chip_smoke.LARGE_PROBES``:

- SWEEP: ``kernels/probes.py``'s ``BULK_*`` / ``ACC_*`` launch constants,
  each checked for exact equality with the plain version;
- ABLATIONS: forms of ``probe_bulk_copy_kernel`` built from
  ``csrc/probes.cu`` with a part taken out or changed (into ``_build/``),
  which say where its time goes: the launch alone, the bulk load alone, a
  4-stage ring.

Prints one line per case and writes ``chiprun_out/probe_sweep.json``.
"""

from __future__ import annotations

import json
import os
import sys

import chip_smoke as smoke

DMA, ACC = "manual HBM->VMEM DMA", "grid accumulation"
# (probe, size, {constant: value})
SWEEP = ([(DMA, "script", dict(BULK_MIN_CHUNK=c)) for c in (64, 128, 256, 512, 1024, 4096)]
         + [(DMA, "large", dict(BULK_CTAS_PER_SM=k, BULK_MAX_CHUNK=c)) for k, c in
            ((2, 4096), (4, 4096), (6, 4096), (4, 2048), (8, 2048), (12, 1024))]
         + [(ACC, "script", dict(ACC_MIN_THREADS=t)) for t in (32, 64, 128)]
         + [(ACC, "large", dict(ACC_THREADS=t, ACC_CTAS_PER_SM=k)) for t, k in
            ((128, 16), (128, 32), (128, 64), (256, 32), (128, 10 ** 6))])

_STORE = '''    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                 :: "l"(dst + c * chunk), "r"(ring_addr + s * stage_bytes),
                    "r"(chunk_bytes(c))
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
'''
_HEAD = "  extern __shared__ __align__(128) float ring[];\n"
# name -> ((old, new) text replacements in csrc/probes.cu, constants, exact?)
ABLATIONS = {
    "launch_only": ([(_HEAD, "  return;\n" + _HEAD)], {}, False),
    "load_only": ([(_STORE, "")], {}, False),
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
              dict(BULK_MAX_CHUNK=2048, BULK_CTAS_PER_SM=8), True),
}


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
    probes.bulk_copy_plan.cache_clear()
    probes.accumulate_plan.cache_clear()
    try:
        args = (probes.probe_args(builder, torch.device(smoke.DEVICE))[0]
                if size == "script" else smoke.large_probe_args(probe))
        if exact and not torch.equal(kernel(*args), probes.PLAINS[kernel](*args)):
            raise RuntimeError(f"{probe} {consts}: kernel and plain differ")
        return smoke.yardstick_turns(probes, probe, kernel, args, size)
    finally:
        for k, v in saved.items():
            setattr(probes, k, v)
        probes.bulk_copy_plan.cache_clear()
        probes.accumulate_plan.cache_clear()
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
    for name, (_, consts, exact) in ABLATIONS.items():
        probes.LIBRARY = ablated[name]
        try:
            for size in ("script", "large"):
                print(f"ablation {name} {size} {consts}:", flush=True)
                out.append(dict(probe=DMA, size=size, ablation=name, constants=consts,
                                **_case(probes, DMA, size, consts, exact)))
        finally:
            probes.LIBRARY = shipped
    with open(os.path.join(os.path.dirname(smoke.WORK), "probe_sweep.json"), "w") as f:
        json.dump(dict(card=smoke.card_line(), cases=out), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
