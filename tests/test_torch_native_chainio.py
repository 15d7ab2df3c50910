"""The port's native chain-row formatter (``io/native.py``,
``ptmcmcsampler_torch/csrc/chainio.cpp``) against its plain version and the
JAX package's ``format_rows``.

* Byte for byte against ``chainfile.format_rows_plain`` (Python's
  ``%22.22f``) on the values where the two printers could part: +-0.0,
  +-inf, NaN of either sign, subnormals, 1e+-300 and the largest double,
  float32 values upcast, in the parameter columns and in the four trailing
  ``%f`` columns; on rows wider than 1024 columns; and with a first buffer
  too short for the rows (grown, then formatted again).
* Against the JAX package's ``format_rows`` (its C++ formatter where built,
  else numpy) on the same rows, except NaNs with the sign bit set, which the
  JAX package's C++ formatter writes as ``-nan`` (ROADMAP §C note).
* The build: into the build directory under a hash of the source, safe
  when several builders race, and a failure raises (no fallback).
"""

import threading

import numpy as np
import pytest

from ptmcmcsampler_torch.io import chainfile, native
from ptmcmcsampler_tpu.io import chainfile as jchainfile

NEG_NAN = -np.float64(np.nan)  # a NaN with its sign bit set
SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, NEG_NAN, 5e-324, -2.2250738585072e-308,
                    1e-300, -1e-300, 1e300, -1e300, np.finfo(np.float64).max,
                    -np.finfo(np.float64).max, 9.9999999999, 0.5, -123.456789012345678,
                    float(np.float32(0.1)), float(np.float32(-3.4e38)),
                    float(np.float32(1.4e-45))])


def _rows(n, ndim, seed, specials=True, signed_nan=True):
    """Rows of f32-upcast normals with the special values sprinkled over
    every column (``signed_nan=False``: without the sign-bit NaN)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(scale=30.0, size=(n, ndim + 4)).astype(np.float32).astype(np.float64)
    if specials:
        values = SPECIAL if signed_nan else SPECIAL[~(np.isnan(SPECIAL) & np.signbit(SPECIAL))]
        picks = rng.random(table.shape) < 0.3
        table[picks] = rng.choice(values, size=int(picks.sum()))
    return table[:, :ndim], *table[:, ndim:].T


@pytest.mark.parametrize("ndim", [1, 2, 50])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_byte_equal_plain_on_special_values(ndim, seed):
    rows = _rows(64, ndim, seed)
    text = native.format_rows(*rows)
    assert text == chainfile.format_rows_plain(*rows)
    assert "-nan" not in text and text.count("\n") == 64


def test_every_special_value_in_every_column_kind():
    """Each special value once as a parameter and once in each trailing
    column (a row each)."""
    n = len(SPECIAL)
    params = np.stack([SPECIAL, SPECIAL[::-1]], 1)
    tails = [np.roll(SPECIAL, k) for k in range(4)]
    text = native.format_rows(params, *tails)
    assert text == chainfile.format_rows_plain(params, *tails)
    lines = text.splitlines()
    assert len(lines) == n and all(len(line.split("\t")) == 6 for line in lines)
    # The NaN of either sign at the field's width, as Python writes it.
    assert lines[4].split("\t")[0] == "%22s" % "nan" == lines[5].split("\t")[0]


def test_native_wider_than_1024_columns():
    rows = _rows(6, 1100, 3)
    assert native.format_rows(*rows) == chainfile.format_rows_plain(*rows)


@pytest.mark.parametrize("cap", [1, 16, 300])
def test_short_buffer_is_grown_and_retried(cap):
    rows = _rows(8, 5, 4)
    assert native.format_rows(*rows, cap=cap) == chainfile.format_rows_plain(*rows)


def test_capacity_holds_the_widest_rows():
    """Every column at the largest double: the bound from the data holds
    the text exactly as formatted (no retry)."""
    big = np.full((3, 4), -np.finfo(np.float64).max)
    tail = [np.full(3, -np.finfo(np.float64).max)] * 4
    text = native.format_rows(big, *tail)
    assert text == chainfile.format_rows_plain(big, *tail)
    assert len(text) < native.capacity(big, np.concatenate(tail))
    assert native.format_rows(big, *tail, cap=native.capacity(big, np.concatenate(tail))) == text


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_byte_equal_jax_format_rows(seed):
    rows = _rows(40, 7, seed, signed_nan=False)
    assert native.format_rows(*rows) == jchainfile.format_rows(*rows)


def test_chain_writer_formats_natively(tmp_path, monkeypatch):
    calls = []
    real = native.format_rows

    def counting(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(native, "format_rows", counting)
    w = chainfile.ChainWriter(str(tmp_path), [1.0])
    rows = _rows(5, 3, 5)
    w.append(0, *rows)
    assert calls == [(5, 3)]
    with open(chainfile.chain_filename(str(tmp_path), 1.0)) as f:
        assert f.read() == chainfile.format_rows_plain(*rows)
    assert set(w.seconds) == {"format", "write"}


def test_library_named_by_its_source(tmp_path, monkeypatch):
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libchainio-")
    other = tmp_path / "chainio.cpp"
    other.write_bytes(native.SOURCE.read_bytes() + b"\n// changed\n")
    monkeypatch.setattr(native, "SOURCE", other)
    assert native.library_path() != path


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    got, errors = [], []

    def build():
        try:
            got.append(native.build())
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(got)) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [got[0].name]


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "chainio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native chain-row formatter failed"):
        native.format_rows(*_rows(2, 2, 0))
    assert not any((tmp_path / "build").iterdir())  # no partial library left


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        native.load()
