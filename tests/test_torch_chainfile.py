"""The port's chain files and host diagnostics against the JAX package's.

* ``format_rows`` is byte-equal to the JAX package's (which uses its C++
  formatter when built) on random rows with -inf, NaN and 1e6 in them.
* Mirrors of ``tests/test_chainfile_parts.py`` (``TestPartMerge``,
  ``TestResumeTruncation``) on the port's ``ChainWriter``.
* The single-chain autocorrelation diagnostics (the ``neff`` stop) equal
  the JAX package's to the last bit: both are the same numpy code.
"""

import os

import numpy as np
import pytest

from ptmcmcsampler_torch import diagnostics as tdiag
from ptmcmcsampler_torch.io.chainfile import ChainWriter, chain_filename, format_rows
from ptmcmcsampler_tpu import diagnostics as jdiag
from ptmcmcsampler_tpu.io import chainfile as jchainfile


def _rows(case, n=40, ndim=3, seed=0):
    """Random rows with the case's special values sprinkled in. NaN is the
    positive quiet NaN numpy makes: the JAX package's C++ formatter writes
    a NaN with its sign bit set as "-nan", its numpy path (and the port) as
    "nan"."""
    rng = np.random.default_rng(seed)
    params = rng.normal(scale=3.0, size=(n, ndim))
    cols = [rng.normal(scale=50.0, size=n) for _ in range(2)]
    cols += [rng.random(n), rng.random(n)]
    special = {"neginf": -np.inf, "nan": np.nan, "big": 1e6, "mixed": None}[case]
    picks = rng.random((n, ndim + 4)) < 0.2
    values = [-np.inf, np.nan, 1e6, -1e6, 0.0] if special is None else [special]
    table = np.concatenate([params, np.stack(cols, 1)], 1)
    table[picks] = rng.choice(values, size=int(picks.sum()))
    return table[:, :ndim], *table[:, ndim:].T


@pytest.mark.parametrize("case", ["neginf", "nan", "big", "mixed"])
def test_format_rows_byte_equal_jax(case):
    rows = _rows(case)
    assert format_rows(*rows) == jchainfile.format_rows(*rows)


def test_chain_filename_matches_jax(tmp_path):
    for temp, hot in ((1.0, False), (1.5811388300841898, False), (1, False), (1e80, True)):
        assert chain_filename(str(tmp_path), temp, hot) == jchainfile.chain_filename(
            str(tmp_path), temp, hot)


def test_writer_files_byte_equal_jax(tmp_path):
    """The same appends through both writers give the same bytes in every
    file: text rows, sidecar and its metadata, jump statistics, cov.npy."""
    ladder = [1.0, 1.7]
    rng = np.random.default_rng(1)
    dirs = {}
    for name, cls in (("port", ChainWriter), ("jax", jchainfile.ChainWriter)):
        out = str(tmp_path / name)
        w = cls(out, ladder, write_hot_chains=True)
        w.init_jump_files(["a", "b"])
        for i in range(2):
            w.reset_all(i, 5, 3)
        dirs[name] = (w, out)
    for _ in range(3):
        block = rng.normal(size=(4, 5, 3)).astype(np.float32)
        scal = rng.normal(size=(4, 4))
        jp, ja = rng.integers(1, 100, 2), rng.integers(0, 50, 2)
        cov = rng.normal(size=(3, 3))
        for w, _ in dirs.values():
            for i in range(2):
                w.append(i, block[:, 0], *scal.T)
                w.append_all(i, block)
            w.write_jump_stats(["a", "b"], [1.0, 3.0], jp, ja)
            w.write_cov(cov)
    port, jax = dirs["port"][1], dirs["jax"][1]
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(jax))
    for name in names:
        with open(os.path.join(port, name), "rb") as a:
            with open(os.path.join(jax, name), "rb") as b:
                assert a.read() == b.read(), name


def _block(row0, rows, nchains, ndim):
    """Distinct deterministic rows: value encodes (global_row, chain, dim)."""
    r = np.arange(row0, row0 + rows)[:, None, None]
    c = np.arange(nchains)[None, :, None]
    d = np.arange(ndim)[None, None, :]
    return (r * 100 + c * 10 + d).astype(np.float32)


class TestPartMerge:
    def test_torn_part_stays_row_aligned(self, tmp_path):
        """Part A one block ahead of part B: load_all merges on the common
        row range, keeping every chain's row r at global iteration r."""
        w = ChainWriter(str(tmp_path), [1.0])
        total, d = 4, 3
        w.reset_all(0, 2, d, cstart=0, nchains_total=total)
        w.reset_all(0, 2, d, cstart=2, nchains_total=total)
        full = _block(0, 5, total, d)
        w.append_all(0, full[:4, 0:2], cstart=0, nchains_total=total)
        w.append_all(0, full[:3, 2:4], cstart=2, nchains_total=total)
        w.append_all(0, full[4:5, 0:2], cstart=0, nchains_total=total)

        assert w.all_rows_count(0) == 3
        merged = w.load_all(0)
        assert merged.shape == (3, total, d)
        np.testing.assert_array_equal(merged, full[:3])

        tail = w.load_all(0, tail_rows=2)
        np.testing.assert_array_equal(tail, full[1:3])

    def test_clear_stale_sidecars(self, tmp_path):
        w = ChainWriter(str(tmp_path), [1.0])
        w.reset_all(0, 4, 2)
        w.append_all(0, _block(0, 2, 4, 2))
        w.reset_all(0, 1, 2, cstart=3, nchains_total=4)
        assert w.load_all(0) is not None
        w.clear_stale_sidecars(0)
        assert w.load_all(0) is None
        assert w.all_rows_count(0) == 0


class TestResumeTruncation:
    def test_truncate_parts_then_rerun_block_stays_aligned(self, tmp_path):
        w = ChainWriter(str(tmp_path), [1.0])
        total, d = 4, 3
        w.reset_all(0, 2, d, cstart=0, nchains_total=total)
        w.reset_all(0, 2, d, cstart=2, nchains_total=total)
        full = _block(0, 6, total, d)
        w.append_all(0, full[:5, 0:2], cstart=0, nchains_total=total)
        w.append_all(0, full[:3, 2:4], cstart=2, nchains_total=total)

        w.truncate_all(0, base_rows=4, part_rows=3)
        assert w.all_rows_count(0) == 3

        w.append_all(0, full[3:5, 0:2], cstart=0, nchains_total=total)
        w.append_all(0, full[3:5, 2:4], cstart=2, nchains_total=total)
        merged = w.load_all(0)
        assert merged.shape == (5, total, d)
        np.testing.assert_array_equal(merged, full[:5])

    def test_truncate_base_sidecar(self, tmp_path):
        w = ChainWriter(str(tmp_path), [1.0])
        w.reset_all(0, 3, 2)
        full = _block(0, 5, 3, 2)
        w.append_all(0, full)
        w.truncate_all(0, base_rows=2, part_rows=0)
        got = w.load_all(0)
        assert got.shape == (2, 3, 2)
        np.testing.assert_array_equal(got, full[:2])
        w.truncate_all(0, base_rows=10, part_rows=0)
        assert w.all_rows_count(0) == 2

    def test_truncate_text(self, tmp_path):
        w = ChainWriter(str(tmp_path), [1.0])
        lines = ["%d\t%f\n" % (i, 0.5 * i) for i in range(6)]
        with open(w.fnames[0], "w") as f:
            f.writelines(lines)
        w.truncate_text(0, 4)
        with open(w.fnames[0]) as f:
            assert f.readlines() == lines[:4]
        w.truncate_text(0, 10)
        with open(w.fnames[0]) as f:
            assert f.readlines() == lines[:4]
        w.truncate_text(0, 0)
        with open(w.fnames[0]) as f:
            assert f.readlines() == []

    def test_truncate_jump_files(self, tmp_path):
        w = ChainWriter(str(tmp_path), [1.0])
        names = ["am", "scam"]
        w.init_jump_files(names)
        for k in range(5):
            w.write_jump_stats(names, [1, 1], [10 * (k + 1)] * 2, [k + 1] * 2)
        w.truncate_jump_files(names, 3)
        for name in names:
            with open(os.path.join(str(tmp_path), name + "_jump.txt")) as f:
                assert len(f.readlines()) == 3


@pytest.mark.parametrize("rho", [0.0, 0.7, 0.97])
def test_autocorr_diagnostics_equal_jax(rho):
    rng = np.random.default_rng(5)
    n, d = 600, 3
    x = np.zeros((n, d))
    e = rng.normal(size=(n, d))
    for t in range(1, n):
        x[t] = rho * x[t - 1] + e[t]
    np.testing.assert_array_equal(tdiag.autocorr_function(x[:, 0]),
                                  jdiag.autocorr_function(x[:, 0]))
    assert tdiag.integrated_autocorr_time(x[:, 1]) == jdiag.integrated_autocorr_time(x[:, 1])
    assert tdiag.max_autocorr_time(x) == jdiag.max_autocorr_time(x)
    assert tdiag.effective_samples(x, 1000) == jdiag.effective_samples(x, 1000)
