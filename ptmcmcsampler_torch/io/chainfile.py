"""Reference-compatible chain-file output (host numpy; a copy of the JAX
package's ``io/chainfile.py``).

File layout parity with ``_writeToFile`` (PTMCMCSampler.py:722-766):
  * ``chain_<temp>.txt`` (or ``chain_hot.txt`` for the prior-sampling chain,
    :281-285): rows of ``ndim + 4`` columns — parameters (%22.22f,
    tab-separated), then log-posterior, log-likelihood, cumulative acceptance
    rate, PT swap acceptance rate (%f each);
  * ``jumps.txt``: each proposal's share of the cycle (:752-760);
  * ``<jumpname>_jump.txt``: per-proposal acceptance-rate time series,
    appended at every write (:762-766);
  * ``cov.npy``: current proposal covariance (:349-351);
  * ``chain_all_<temp>.bin`` + ``.json``: every chain of a written
    temperature, raw float32 rows (the batched sampler's extension).

Rows are formatted by the port's copy of the JAX package's C++ formatter
(``io/native.py``, ``csrc/chainio.cpp``), built at first use, with no
fallback; :func:`format_rows_plain` is its plain version, Python's
``%22.22f``, which writes the same bytes (a NaN as ``nan`` in both).
"""

from __future__ import annotations

import glob
import json
import os
import time

import numpy as np

from . import native


def chain_filename(outdir, temp, hot=False):
    if hot:
        return os.path.join(outdir, "chain_hot.txt")
    return os.path.join(outdir, "chain_{0}.txt".format(temp))


def format_rows(params, lnprob, lnlike, accept_rate, pt_accept_rate):
    """Format rows as the reference writes them (PTMCMCSampler.py:741-745),
    with the native formatter."""
    return native.format_rows(params, lnprob, lnlike, accept_rate, pt_accept_rate)


def format_rows_plain(params, lnprob, lnlike, accept_rate, pt_accept_rate):
    """:func:`format_rows` in Python (the reference's own formatting): the
    native formatter's plain version."""
    n, ndim = params.shape
    lines = []
    for i in range(n):
        cols = "\t".join("%22.22f" % params[i, k] for k in range(ndim))
        lines.append(
            cols
            + "\t%f\t%f\t%f\t%f\n"
            % (lnprob[i], lnlike[i], accept_rate[i], pt_accept_rate[i])
        )
    return "".join(lines)


class ChainWriter:
    """Per-temperature chain files + jump statistics for one sampler run."""

    def __init__(self, outdir, ladder, hot_chain=False, write_hot_chains=False, resume=False,
                 seconds=None):
        self.outdir = outdir
        # Host seconds by part, summed over calls: "format" (the rows'
        # text), "write" (the chain files), "sidecar" (the all-chain rows).
        self.seconds = {} if seconds is None else seconds
        self.ladder = np.asarray(ladder, dtype=np.float64)
        self.hot_chain = hot_chain
        self.write_hot_chains = write_hot_chains
        os.makedirs(outdir, exist_ok=True)
        self.ntemps = len(self.ladder)
        self.fnames = []
        for i, temp in enumerate(self.ladder):
            hot = hot_chain and i == self.ntemps - 1 and self.ntemps > 1
            self.fnames.append(chain_filename(outdir, temp, hot=hot))
        if not resume:
            for i, fn in enumerate(self.fnames):
                if self._writes_temp(i):
                    open(fn, "w").close()

    def _writes_temp(self, i):
        # Reference: rank 0 always writes; hot chains only with writeHotChains
        # (PTMCMCSampler.py:346).
        return i == 0 or self.write_hot_chains

    def existing_rows(self, i):
        fn = self.fnames[i]
        if not os.path.isfile(fn):
            return None
        try:
            data = np.loadtxt(fn, ndmin=2)
        except ValueError as err:  # PTMCMCSampler.py:297-299
            raise RuntimeError("Couldn't read old chain to resume") from err
        return data

    def append(self, i, params, lnprob, lnlike, accept_rate, pt_accept_rate):
        if not self._writes_temp(i):
            return
        t0 = time.perf_counter()
        text = format_rows(
            np.asarray(params, np.float64),
            np.asarray(lnprob, np.float64),
            np.asarray(lnlike, np.float64),
            np.asarray(accept_rate, np.float64),
            np.asarray(pt_accept_rate, np.float64),
        )
        t1 = time.perf_counter()
        with open(self.fnames[i], "a") as f:
            f.write(text)
        self._add("format", t1 - t0)
        self._add("write", time.perf_counter() - t1)

    def _add(self, part, sec):
        self.seconds[part] = self.seconds.get(part, 0.0) + sec

    # ---- all-chain binary output (batched-sampler extension) ----------
    #
    # The text chain files carry one chain per temperature for byte parity
    # with the reference (one MPI rank = one chain, PTMCMCSampler.py:96-97);
    # the batched ``nchains`` axis — the main throughput axis — is
    # harvested into an appendable raw-float32 sidecar per temperature,
    # ``chain_all_<temp>.bin`` + ``.json`` metadata.

    def _all_paths(self, i, cstart=None):
        base = os.path.splitext(os.path.basename(self.fnames[i]))[0]
        stem = os.path.join(self.outdir, base.replace("chain_", "chain_all_"))
        if cstart is not None:
            stem = stem + ".c{0}".format(int(cstart))
        return stem + ".bin", stem + ".json"

    def reset_all(self, i, nchains, ndim, cstart=None, nchains_total=None):
        if not self._writes_temp(i):
            return
        binf, metaf = self._all_paths(i, cstart)
        open(binf, "wb").close()
        meta = {"nchains": int(nchains), "ndim": int(ndim), "dtype": "float32"}
        if cstart is not None:
            # Part file written by the process owning chains
            # [cstart, cstart + nchains) of a multi-process run.
            meta["chain_offset"] = int(cstart)
            meta["nchains_total"] = int(nchains_total)
        with open(metaf, "w") as f:
            json.dump(meta, f)

    def clear_stale_sidecars(self, i):
        """Remove the base all-chain sidecar AND every part sidecar of
        temperature ``i``. Fresh multi-process runs call this (process 0,
        before the first collective step): part files are reset lazily by
        their owners, so a stale base sidecar — or parts from a previous run
        with a different process layout — would otherwise shadow or pollute
        the new parts in ``load_all``/``all_rows_count``."""
        binf, metaf = self._all_paths(i)
        stem = binf[: -len(".bin")]
        stale = [binf, metaf]
        stale += glob.glob(stem + ".c*.bin") + glob.glob(stem + ".c*.json")
        for p in stale:
            if os.path.isfile(p):
                os.remove(p)

    def append_all(self, i, block, cstart=None, nchains_total=None):
        """Append thinned rows: block [rows, nchains_local, ndim].

        ``cstart`` (multi-process) appends to this process's part file
        ``chain_all_<T>.c<cstart>.bin`` instead of the base sidecar.
        """
        if not self._writes_temp(i):
            return
        t0 = time.perf_counter()
        binf, metaf = self._all_paths(i, cstart)
        if not os.path.isfile(metaf):  # e.g. resuming a pre-existing run dir
            meta = {"nchains": int(block.shape[1]), "ndim": int(block.shape[2]),
                    "dtype": "float32"}
            if cstart is not None:
                meta["chain_offset"] = int(cstart)
                meta["nchains_total"] = int(nchains_total)
            with open(metaf, "w") as f:
                json.dump(meta, f)
        with open(binf, "ab") as f:
            f.write(np.ascontiguousarray(block, dtype=np.float32).tobytes())
        self._add("sidecar", time.perf_counter() - t0)

    def _part_metas(self, i):
        """Metadata for every part sidecar of temperature ``i`` (may be [])."""
        base_bin, _ = self._all_paths(i)
        stem = base_bin[: -len(".bin")]
        parts = []
        for metaf in sorted(glob.glob(stem + ".c*.json")):
            with open(metaf) as f:
                meta = json.load(f)
            binf = metaf[: -len(".json")] + ".bin"
            if os.path.isfile(binf):
                parts.append((binf, meta))
        return parts

    def all_rows_count(self, i):
        """Number of rows currently in the all-chain sidecar (0 if absent)."""
        binf, metaf = self._all_paths(i)
        if os.path.isfile(binf) and os.path.isfile(metaf):
            with open(metaf) as f:
                meta = json.load(f)
            row_bytes = meta["nchains"] * meta["ndim"] * np.dtype(
                meta.get("dtype", "float32")
            ).itemsize
            return os.path.getsize(binf) // max(row_bytes, 1)
        parts = self._part_metas(i)
        if not parts:
            return 0
        counts = []
        for pbin, meta in parts:
            row_bytes = meta["nchains"] * meta["ndim"] * np.dtype(
                meta.get("dtype", "float32")
            ).itemsize
            counts.append(os.path.getsize(pbin) // max(row_bytes, 1))
        return min(counts)

    @staticmethod
    def _read_tail(binf, rows_avail, take, c, d, dtype):
        row_bytes = c * d * dtype.itemsize
        with open(binf, "rb") as f:
            f.seek((rows_avail - take) * row_bytes)
            raw = np.frombuffer(f.read(take * row_bytes), dtype=dtype)
        return raw.reshape(take, c, d)

    def load_all(self, i, tail_rows=None):
        """All-chain thinned history [rows, nchains, ndim] (or None).

        ``tail_rows`` reads only the last N rows (seek-based — a resume on a
        huge run never has to materialize the whole file in RAM). If the base
        sidecar is absent, per-process part files from a multi-process run
        are merged on their recorded chain offsets.
        """
        binf, metaf = self._all_paths(i)
        if os.path.isfile(binf) and os.path.isfile(metaf):
            with open(metaf) as f:
                meta = json.load(f)
            c, d = meta["nchains"], meta["ndim"]
            dtype = np.dtype(meta.get("dtype", "float32"))
            rows = os.path.getsize(binf) // (c * d * dtype.itemsize)
            if rows == 0:
                return None
            take = rows if tail_rows is None else min(int(tail_rows), rows)
            return self._read_tail(binf, rows, take, c, d, dtype)
        parts = self._part_metas(i)
        if not parts:
            return None
        total = parts[0][1].get("nchains_total")
        if total is None:
            return None
        d = parts[0][1]["ndim"]
        rows = self.all_rows_count(i)
        if rows == 0:
            return None
        take = rows if tail_rows is None else min(int(tail_rows), rows)
        out = np.full((take, total, d), np.nan, np.float32)
        for pbin, meta in parts:
            c = meta["nchains"]
            dtype = np.dtype(meta.get("dtype", "float32"))
            off = meta["chain_offset"]
            # Seek relative to the COMMON row count (min over parts), not
            # this part's own length: a process killed between appends
            # leaves one part a block longer, and per-part tails would
            # silently merge different iterations into one row.
            out[:, off : off + c] = self._read_tail(pbin, rows, take, c, d, dtype)
        return out

    # ---- resume truncation -------------------------------------------
    #
    # A process killed between a block drain and its checkpoint leaves the
    # chain files / sidecars one block AHEAD of the checkpoint. Resume
    # restarts from the checkpoint and re-runs that block, so any rows past
    # the checkpoint must be dropped first — otherwise the re-run block is
    # appended a second time and (for part sidecars, whose merge aligns on a
    # common row index) every subsequent row of the already-ahead part is
    # permanently offset.

    @staticmethod
    def _truncate_binary(path, nbytes):
        if os.path.isfile(path) and os.path.getsize(path) > nbytes:
            with open(path, "r+b") as f:
                f.truncate(nbytes)

    def truncate_all(self, i, base_rows, part_rows):
        """Drop sidecar rows past a known count (checkpoint resume).

        ``base_rows`` bounds the single-process base sidecar (which includes
        the seed row); ``part_rows`` bounds each multi-process part sidecar
        (which starts after the seed row).
        """
        binf, metaf = self._all_paths(i)
        if os.path.isfile(binf) and os.path.isfile(metaf):
            with open(metaf) as f:
                meta = json.load(f)
            row_bytes = meta["nchains"] * meta["ndim"] * np.dtype(
                meta.get("dtype", "float32")
            ).itemsize
            self._truncate_binary(binf, base_rows * row_bytes)
        for pbin, meta in self._part_metas(i):
            row_bytes = meta["nchains"] * meta["ndim"] * np.dtype(
                meta.get("dtype", "float32")
            ).itemsize
            self._truncate_binary(pbin, part_rows * row_bytes)

    def truncate_text(self, i, nrows):
        """Keep only the first ``nrows`` lines of chain file ``i``."""
        self._truncate_lines(self.fnames[i], nrows)

    @staticmethod
    def _truncate_lines(fn, nrows):
        if not os.path.isfile(fn):
            return
        if nrows <= 0:
            with open(fn, "r+b") as f:
                f.truncate(0)
            return
        offset = 0
        count = 0
        with open(fn, "rb") as f:
            for line in f:
                count += 1
                offset += len(line)
                if count >= nrows:
                    break
        if count >= nrows:
            with open(fn, "r+b") as f:
                f.truncate(offset)

    def truncate_jump_files(self, jump_names, nrows):
        """Keep only the first ``nrows`` entries of each per-jump
        acceptance-rate series (one line is appended per drain, so a torn
        resume must also drop the entries past the checkpoint)."""
        for name in jump_names:
            self._truncate_lines(
                os.path.join(self.outdir, name + "_jump.txt"), nrows
            )

    def write_cov(self, cov):
        np.save(os.path.join(self.outdir, "cov.npy"), np.asarray(cov))

    def init_jump_files(self, jump_names, resume=False):
        if resume:
            return
        for name in jump_names:
            open(os.path.join(self.outdir, name + "_jump.txt"), "w").close()

    def write_jump_stats(self, jump_names, weights, proposed, accepted):
        """jumps.txt cycle fractions + per-jump acceptance append
        (PTMCMCSampler.py:749-766)."""
        weights = np.asarray(weights, dtype=np.float64)
        total = max(weights.sum(), 1.0)
        with open(os.path.join(self.outdir, "jumps.txt"), "w") as f:
            for name, w in zip(jump_names, weights):
                f.write("%s %4.2g\n" % (name, w / total))
        for j, name in enumerate(jump_names):
            rate = accepted[j] / max(1.0, proposed[j])
            with open(os.path.join(self.outdir, name + "_jump.txt"), "a") as f:
                f.write("%g\n" % rate)
