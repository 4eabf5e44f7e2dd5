"""The plain reference on cases worked out by hand, and what it imports."""

import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sparse
import torch

from benchmarks import reference as ref
from conftest import ROOT


def test_moments_by_hand():
    # 3 cells x 2 genes, factors 1, 2, 4, capture q = 0.1
    X = sparse.csr_matrix(np.array([[1.0, 0.0], [2.0, 3.0], [4.0, 1.0]]))
    sf = torch.tensor([1.0, 2.0, 4.0], dtype=torch.float64)
    m, v = ref.moments(ref.to_coo(X, torch.float64, "cpu"), sf, 0.1)
    x = X.toarray()
    s = sf.numpy()[:, None]
    m_hand = (x / s).mean(0)
    v_hand = (x**2 / s**2).mean(0) - 0.9 * (x / s**2).mean(0) - m_hand**2
    np.testing.assert_allclose(m.numpy(), m_hand, rtol=1e-15)
    np.testing.assert_allclose(v.numpy(), v_hand, rtol=1e-14)


def test_bin_factors_by_hand():
    sf = np.array([1.0, 1.1, 2.0, 3.0])
    # edges 1, 2, 3: {1, 1.1} -> 1.05; {2, 3} -> 2.5, the largest kept
    np.testing.assert_allclose(ref.bin_factors(sf, 2), [1.05, 1.05, 2.5, 3.0])


def test_polyfit_recovers_a_parabola():
    m = np.exp(np.linspace(-3, 2, 50))
    lm = np.log(m)
    v = np.exp(0.1 * lm * lm + 1.2 * lm - 0.5)
    np.testing.assert_allclose(ref.polyfit2(m, v), [0.1, 1.2, -0.5],
                               atol=1e-10)


def test_meta_regression_is_a_weighted_difference_of_means():
    # groups 0, 1 control, 2, 3 treated; weights 1, 3, 1, 1
    stats = torch.tensor([[[1.0], [2.0], [5.0], [6.0]]], dtype=torch.float64)
    w = torch.tensor([[1.0, 3.0, 1.0, 1.0]], dtype=torch.float64)
    t = np.array([0.0, 0.0, 1.0, 1.0])
    coef = ref.meta_regress(stats, w, np.zeros((4, 0)), t)
    assert coef.item() == pytest.approx(5.5 - 1.75)
    # with a covariate that is itself an intercept the slope is the same
    coef = ref.meta_regress(stats, w, np.ones((4, 1)), t)
    assert coef.item() == pytest.approx(3.75)


def test_meta_regression_one_sample_and_no_contrast():
    stats = torch.tensor([[[1.0], [2.0], [5.0], [6.0]]], dtype=torch.float64)
    t = np.array([0.0, 0.0, 1.0, 1.0])
    # only the treated groups weighted: one sample, the weighted average
    w = torch.tensor([[0.0, 0.0, 1.0, 3.0]], dtype=torch.float64)
    assert ref.meta_regress(stats, w, np.zeros((4, 0)), t).item() == \
        pytest.approx(5.75)
    # only the controls weighted: no contrast, NaN
    w = torch.tensor([[1.0, 1.0, 0.0, 0.0]], dtype=torch.float64)
    assert np.isnan(ref.meta_regress(stats, w, np.zeros((4, 0)), t).item())


def test_counting_pvalue_and_se_by_hand():
    # observed 0.5; replicates 0.5 + d: |d| > 0.5 for 2 of 5
    d = np.array([0.1, -0.7, 0.6, 0.0, -0.2])
    full = torch.tensor([[0.5, *(0.5 + d)]], dtype=torch.float64)
    r = ref.finish(full)
    assert r.pval[0] == pytest.approx(3 / 6)
    assert r.se[0] == pytest.approx(np.std(0.5 + d))
    # every coefficient equal: degenerate, NaN
    assert np.isnan(ref.finish(torch.ones((1, 6), dtype=torch.float64))
                    .pval[0])


def test_supported_settings_only():
    cfg = {"estimator": "hyper_relative"}
    tr = {"resampling": "bootstrap", "approx": False,
          "sampler": "multinomial"}
    ref.supported(cfg, tr)
    for c, t in [({"estimator": "poisson"}, {}),
                 ({}, {"resampling": "permutation"}),
                 ({}, {"approx": True}), ({}, {"sampler": "gaussian"})]:
        with pytest.raises(ValueError):
            ref.supported(dict(cfg, **c), dict(tr, **t))


def test_control_precision_is_one_step_below_the_stated():
    p = ref.precisions({"precision": {"host_stages": "float64",
                                      "device_program": "float32"}})
    assert p["reference"] == {"host": torch.float64, "device": torch.float64}
    assert p["control"] == {"host": torch.float32, "device": torch.bfloat16}


def test_corr_sentinels():
    cov = torch.tensor([0.5, 0.5, 3.0, float("nan")], dtype=torch.float64)
    v1 = torch.tensor([1.0, -1.0, 1.0, 1.0], dtype=torch.float64)
    v2 = torch.ones(4, dtype=torch.float64)
    r = ref.corr(cov, v1, v2)
    assert r[0] == 0.5 and r[1] == 1.0 and r[2] == 1.0 and torch.isnan(r[3])


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; import benchmarks.reference, benchmarks.compare, "
            "benchmarks.data; "
            "tops = {m.split('.')[0] for m in sys.modules}; "
            "bad = tops & {'memento_tpu_torch', 'memento_tpu', 'jax', "
            "'jaxlib', 'flax'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
