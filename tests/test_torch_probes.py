"""The Hopper capability probes (kernels/probes.py) on the CPU.

On CPU tensors each probe wrapper takes its plain PyTorch version; those are
held here to the numpy expectations of the reference script
scripts/probe_pallas.py on its own inputs. The CUDA kernels are held to the
plain versions on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from meshopticalflow_tpu_torch.kernels import probes


@pytest.mark.parametrize("name,ref,kernel,builder", probes.PROBES,
                         ids=[p[0] for p in probes.PROBES])
def test_probe_plain_version_matches_script(name, ref, kernel, builder):
    before = kernel.launches
    res = probes.run_probe(kernel, builder, torch.device("cpu"))
    assert res["correct"] and res["matches_plain"], (name, res)
    assert kernel.launches == before          # CPU tensors: plain version
    assert probes.PLAINS[kernel].cuda_calls == 0


def test_probe_script_expectations_are_the_reference_ones():
    """The inputs and expectations are the reference script's: recompute the
    script's own numpy expressions from its source lines."""
    args, expect = probes._inputs_select()
    x, sel, bs = args
    assert x.shape == (1024, 128) and list(sel) == [3, 1, 4, 1] and bs == 128
    np.testing.assert_array_equal(expect[:128], x[3 * 128:4 * 128] + 1.0)
    args, expect = probes._inputs_dma()
    np.testing.assert_array_equal(expect, args[0][128:256])
    args, expect = probes._inputs_accumulate()
    assert args[0].shape == (4, 3, 8, 128) and expect.shape == (32, 128)


def test_entry_point_reports_each_probe(capsys):
    assert probes.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("[ok]") for line in out) == len(probes.PROBES)


def test_entry_point_fails_on_a_wrong_probe(monkeypatch, capsys):
    name, ref, kernel, builder = probes.PROBES[2]

    def wrong():
        args, expect = builder()
        return args, expect + 1.0

    monkeypatch.setattr(probes, "PROBES",
                        probes.PROBES[:2] + [(name, ref, kernel, wrong)] + probes.PROBES[3:])
    assert probes.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert f"[FAIL] {name}" in out


@pytest.mark.parametrize("case", ["dtype", "shape", "bulk_unaligned"])
def test_probe_wrappers_refuse_bad_operands(case):
    x = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    if case == "dtype":
        with pytest.raises(TypeError):
            probes.scale(x.to(torch.float64))
    elif case == "shape":
        with pytest.raises(ValueError):
            probes.row_gather(x, torch.zeros((2, 4), dtype=torch.int32).t())
    else:
        with pytest.raises(ValueError):
            probes.bulk_copy(torch.zeros((4, 3)), 1, 2)
