"""The NUTS reservoir's counter-based uniforms (``ops/nuts.py``), on the CPU.

* ``philox4x32`` reproduces Random123's known-answer vectors of
  Philox4x32-10, and agrees with a pure-Python Philox on random words.
* ``nuts_uniforms`` lays the words out as the kernel draws them (leaf row
  ``r``, chain ``n = t*C + c``, counter ``(r, n, 0, 0)``, word 0, top 24
  bits), lies in [0, 1), is a function of the key alone, and passes a
  Kolmogorov-Smirnov test against U(0, 1).
* The NUTS step with a key equals the NUTS step fed the key's materialised
  uniforms, bit for bit, with and without a step-size search.
"""

import numpy as np
import pytest
import torch
from scipy import stats

from ptmcmcsampler_torch import config as t_config
from ptmcmcsampler_torch.models import CurvedLikelihood
from ptmcmcsampler_torch.ops import nuts as ops_nuts
from ptmcmcsampler_torch.ops.nuts import nuts_trees, nuts_uniforms, philox4x32
from ptmcmcsampler_torch.proposals import nuts as t_nuts
from ptmcmcsampler_torch.proposals.base import ProposalContext

torch.set_num_threads(2)

MASK = 0xFFFFFFFF
# Random123's kat_vectors for philox4x32_10: (counter, key, output).
KNOWN_ANSWERS = [
    ([0, 0, 0, 0], [0, 0], [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ([MASK] * 4, [MASK] * 2, [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344], [0xA4093822, 0x299F31D0],
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
]


def _philox_ints(ctr, key):
    """Philox4x32-10 on Python integers, as an independent reference."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for i in range(10):
        if i:
            k0, k1 = (k0 + 0x9E3779B9) & MASK, (k1 + 0xBB67AE85) & MASK
        p0, p1 = 0xD2511F53 * c0, 0xCD9E8D57 * c2
        c0, c1, c2, c3 = (p1 >> 32) ^ c1 ^ k0, p1 & MASK, (p0 >> 32) ^ c3 ^ k1, p0 & MASK
    return c0, c1, c2, c3


def _key(a, b):
    return torch.tensor([a, b], dtype=torch.int64)


@pytest.mark.parametrize("ctr,key,expect", KNOWN_ANSWERS)
def test_philox_known_answers(ctr, key, expect):
    out = philox4x32([torch.tensor(w) for w in ctr], [torch.tensor(w) for w in key])
    assert [int(w) for w in out] == expect
    assert list(_philox_ints(ctr, key)) == expect


def test_philox_matches_integer_reference_on_random_words():
    rng = np.random.default_rng(3)
    ctr = rng.integers(0, 2**32, size=(4, 200), dtype=np.int64)
    key = rng.integers(0, 2**32, size=2, dtype=np.int64)
    out = torch.stack(philox4x32([torch.tensor(w) for w in ctr],
                                 [torch.tensor(k) for k in key])).numpy()
    for i in range(ctr.shape[1]):
        want = _philox_ints([int(w) for w in ctr[:, i]], [int(k) for k in key])
        assert tuple(int(w) for w in out[:, i]) == want


def test_nuts_uniforms_layout():
    """Row r, rung t, chain c is the first known answer's layout: word 0 of
    counter (r, t*C + c, 0, 0), top 24 bits."""
    t, c, depth = 3, 5, 4
    key = (0x12345678, 0x9ABCDEF0)
    u = nuts_uniforms(_key(*key), depth, t, c)
    assert u.shape == ((1 << depth) - 1, t, c) and u.dtype == torch.float32
    for r, ti, ci in [(0, 0, 0), (14, 2, 4), (6, 1, 3), (3, 0, 4)]:
        word = _philox_ints((r, ti * c + ci, 0, 0), key)[0]
        assert float(u[r, ti, ci]) == (word >> 8) * 2.0**-24
    zero = nuts_uniforms(_key(0, 0), 1, 1, 1)
    assert float(zero[0, 0, 0]) == (KNOWN_ANSWERS[0][2][0] >> 8) * 2.0**-24


def test_nuts_uniforms_law_and_key():
    depth, t, c = 10, 2, 64
    u = nuts_uniforms(_key(7, 11), depth, t, c)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert torch.equal(u, nuts_uniforms(_key(7, 11), depth, t, c))
    other = nuts_uniforms(_key(7, 12), depth, t, c)
    assert (u != other).float().mean() > 0.99
    assert stats.kstest(u.flatten().numpy(), "uniform").pvalue > 0.01
    for row in (0, 1, 511, 1022):  # no row is degenerate
        assert stats.kstest(u[row].flatten().numpy(), "uniform").pvalue > 1e-4


def test_nuts_uniforms_chunks_agree(monkeypatch):
    whole = nuts_uniforms(_key(5, 6), 6, 2, 16)
    monkeypatch.setattr(ops_nuts, "_UNIFORMS_CHUNK", 100)  # 3 rows a step
    assert torch.equal(nuts_uniforms(_key(5, 6), 6, 2, 16), whole)


def _tree_args(seed, t, c, depth):
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.normal(size=(t, 2, c))
    x[:, 1] += np.where(rng.random((t, c)) < 0.5, -1.0, 2.0)
    f32 = np.float32
    chol = np.linalg.cholesky(np.array([[0.6, 0.15], [0.15, 0.9]])).astype(f32)
    return dict(
        x=torch.tensor(x, dtype=torch.float32), chol=torch.tensor(chol),
        chol_inv=torch.tensor(np.linalg.inv(chol).astype(f32)),
        betas=torch.tensor(np.geomspace(1.0, 0.3, t).astype(f32)),
        r0=torch.tensor(rng.normal(size=(t, 2, c)).astype(f32)),
        expo=torch.tensor(rng.exponential(size=(t, c)).astype(f32)),
        dirs=torch.tensor(np.where(rng.random((depth, t, c)) < 0.5, -1.0, 1.0).astype(f32)),
        accu=torch.tensor(rng.random((depth, t, c)).astype(f32)),
        r_eps=torch.tensor(rng.normal(size=(t, 2, c)).astype(f32)),
        key=torch.tensor(rng.integers(0, 2**32, size=2), dtype=torch.int64),
    )


def test_nuts_trees_key_equals_materialised_uniforms():
    t, c, depth = 2, 48, 6
    a = _tree_args(1, t, c, depth)
    q0 = (a["chol_inv"].T @ a["x"]).contiguous()
    eps = torch.full((t, c), 0.2)
    eps[:, ::5] = -1.0
    common = (q0, a["r0"], a["betas"], eps, a["expo"], a["dirs"], a["accu"])
    got = nuts_trees(*common, a["key"], a["chol"], CurvedLikelihood(), r_eps=a["r_eps"])
    want = nuts_trees(*common, nuts_uniforms(a["key"], depth, t, c), a["chol"],
                      CurvedLikelihood(), r_eps=a["r_eps"])
    assert len(got) == 7
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[6] > 0).all() and got[4].max() > 1


@pytest.mark.parametrize("first_call", [True, False])
def test_core_with_key_equals_core_with_uniforms(first_call):
    """make_nuts(...).core given a key equals core given the uniforms the key
    stands for, bit for bit (first call: every lane searches its step size)."""
    t, c, depth = 2, 32, 5
    cfg = t_config.SamplerConfig(
        ndim=2, ntemps=t, nchains=c, groups=((0, 1),), burn=100, nuts_max_depth=depth,
        jumps=t_config.build_default_jumps(NUTSweight=1, SCAMweight=0, AMweight=0, DEweight=0,
                                           have_grads=True),
    )
    a = _tree_args(2, t, c, depth)
    ctx = ProposalContext(group_u=None, group_s=None, chol=a["chol"], chol_inv=a["chol_inv"],
                          de_buf=None, de_valid=0)
    vals = (dict(epsilon=-1.0, epsilonbar=1.0, hbar=0.0, mu=0.0, ncalls=0.0) if first_call
            else dict(epsilon=0.2, epsilonbar=0.18, hbar=0.02, mu=np.log(2.0), ncalls=4.0))
    ss = {k: torch.full((t, c), v, dtype=torch.float32) for k, v in vals.items()}
    core = t_nuts.make_nuts(cfg, CurvedLikelihood()).core
    draws = (a["r0"], a["expo"], a["dirs"], a["accu"])
    q1, qxy1, ss1 = core(a["x"], a["betas"], 5, ctx, ss, *draws, a["key"], a["r_eps"])
    q2, qxy2, ss2 = core(a["x"], a["betas"], 5, ctx, ss, *draws,
                         nuts_uniforms(a["key"], depth, t, c), a["r_eps"])
    assert torch.equal(q1, q2) and torch.equal(qxy1, qxy2)
    for k in ss1:
        assert torch.equal(ss1[k], ss2[k]), k
    assert (ss1["epsilon"] > 0).all()
