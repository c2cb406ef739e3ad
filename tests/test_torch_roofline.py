"""The port's roofline against the JAX package's, on the CPU.

``model_flops`` equals JAX's for every arch × shape of ``list_archs()``
(the same analytic formulas over the port's own configs);
``kernel_roofline``, ``bound`` and ``analyze`` on synthetic records use
the H100 figures.
"""

import json

import pytest

from repro.analysis import roofline as JR
from repro.launch.api import get_arch as jax_get_arch
from repro.launch.api import list_archs as jax_list_archs

from repro_torch.analysis import roofline as R
from repro_torch.launch.api import get_arch, list_archs

CELLS = [(a, s) for a in jax_list_archs()
         for s in jax_get_arch(a).shapes]


def _rec(arch, shape, family, **kw):
    rec = {"arch": arch, "shape": shape, "family": family, "mesh": "single",
           "status": "ok", "n_chips": 1,
           "cost": {"flops": 2.0e12, "bytes accessed": 1.0e10},
           "collectives": {"total": 1.0e8},
           "memory": {"peak_bytes": 3 * 2**30}}
    rec.update(kw)
    return rec


def test_archs_and_shapes_match_jax():
    assert list_archs() == jax_list_archs()
    for arch in list_archs():
        assert list(get_arch(arch).shapes) == list(
            jax_get_arch(arch).shapes), arch


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_match_jax(arch, shape):
    rec = {"arch": arch, "shape": shape,
           "family": jax_get_arch(arch).family}
    assert R.model_flops(rec) == JR.model_flops(rec)


def test_h100_figures():
    assert R.HBM_BW == 3.35e12
    assert R.PEAK_FLOPS == 989e12
    assert R.FP32_FLOPS == 67e12
    assert R.NVLINK_BW == 450e9
    assert not hasattr(R, "VMEM_BYTES")


def test_bound_and_kernel_roofline():
    assert R.bound(3.35e9) == (3.35e9 / 3.35e12, "bytes")
    assert R.bound(1e6, 67e9) == (67e9 / 67e12, "operations")
    k = R.kernel_roofline(bytes_moved=6.7e9, seconds=4e-3, flops=6.7e10)
    assert k["achieved_bytes_per_s"] == 6.7e9 / 4e-3
    assert k["bw_fraction"] == pytest.approx(0.5)
    assert k["flops_fraction"] == pytest.approx(6.7e10 / 4e-3 / 67e12)
    assert k["bound_s"] == pytest.approx(2e-3)
    assert k["bound_by"] == "bytes"
    assert k["bound_fraction"] == pytest.approx(0.5)
    assert R.kernel_roofline(1.0, 0.0)["bw_fraction"] == 0.0


def test_analyze_a_synthetic_record():
    a = R.analyze(_rec("olmo-1b", "train_4k", "lm", n_chips=4))
    assert a["compute_s"] == 2.0e12 / 989e12
    assert a["memory_s"] == 1.0e10 / 3.35e12
    assert a["collective_s"] == 1.0e8 / 450e9
    assert a["dominant"] == "memory"
    assert a["model_flops"] == JR.model_flops(
        {"arch": "olmo-1b", "shape": "train_4k", "family": "lm"})
    assert a["hlo_flops_global"] == 8.0e12
    assert a["roofline_fraction"] == pytest.approx(
        a["model_flops"] / 4 / a["memory_s"] / 989e12)
    assert a["peak_bytes_per_dev"] == 3 * 2**30
    assert "memory-bound" in a["suggestion"]
    # JAX's analysis of the same record differs only in its TPU figures
    j = JR.analyze(_rec("olmo-1b", "train_4k", "lm", n_chips=4))
    assert a["compute_s"] * R.PEAK_FLOPS == pytest.approx(
        j["compute_s"] * JR.PEAK_FLOPS)
    assert R.analyze(_rec("xdeepfm", "serve_p99", "recsys",
                          status="skipped")) is None


def test_analyze_scan_probe_and_collective_bound():
    rec = _rec("mind", "train_batch", "recsys",
               collectives={"total": 1.0e10})
    probe = {"status": "ok", "trips": 3,
             "body": {"flops": 1e9, "bytes": 1e6, "collective": 1e6}}
    a = R.analyze(rec, probe)
    assert a["scan_corrected"]
    assert a["compute_s"] == (2.0e12 + 2e9) / 989e12
    assert a["collective_s"] == (1.0e10 + 2e6) / 450e9
    assert a["dominant"] == "collective"


def test_main_writes_the_table(tmp_path, capsys):
    d = tmp_path / "dryrun"
    d.mkdir()
    (d / "a.json").write_text(json.dumps(
        _rec("pytrec-eval", "eval_10k_1k", "eval")))
    (d / "b.json").write_text(json.dumps(
        _rec("olmo-1b", "long_500k", "lm", status="skipped",
             skip_reason="sub-quadratic attention required")))
    out = tmp_path / "roofline.md"
    R.main(["--dryrun", str(d), "--out", str(out)])
    text = out.read_text()
    assert "| pytrec-eval | eval_10k_1k | single |" in text
    assert "olmo-1b×long_500k" in text
    rows = json.loads((tmp_path / "roofline.json").read_text())
    assert rows[0]["model_flops"] == JR.model_flops(
        {"arch": "pytrec-eval", "shape": "eval_10k_1k", "family": "eval"})
    assert "pytrec-eval" in capsys.readouterr().out
