// Native chain-file row formatter of ptmcmcsampler_torch: the port's copy of
// the JAX package's csrc/chainio.cpp, with one intended difference.
//
// It writes the bytes of the reference's Python formatting
// (PTMCMCSampler.py:741-745): ndim columns of "%22.22f" joined by tabs, then
// "\t%f\t%f\t%f\t%f\n" for lnprob, lnlike, the acceptance rate and the PT
// acceptance rate. For finite values and infinities glibc's snprintf and
// CPython's %-formatting print the same exact decimal expansion. The one
// difference is NaN: glibc prints "-nan" for a NaN whose sign bit is set,
// CPython prints "nan"; the port's files have always written "nan", so every
// NaN is written as "nan" at the field's width.
//
// Built with the host C++ compiler at first use (io/native.py), loaded with
// ctypes.

#include <cmath>
#include <cstdio>

namespace {

// Appends one field to out[pos, cap): "%22.22f" (wide) or "%f" of v, after a
// tab if tab. Returns the new position, or -1 if the field does not fit.
long long field(char* out, long long pos, long long cap, double v, bool wide, bool tab) {
  long long room = cap - pos;
  if (room <= 0) return -1;
  int w;
  if (std::isnan(v)) {
    w = snprintf(out + pos, (size_t)room, wide ? (tab ? "\t%22s" : "%22s") : "\t%s", "nan");
  } else if (wide) {
    w = snprintf(out + pos, (size_t)room, tab ? "\t%22.22f" : "%22.22f", v);
  } else {
    w = snprintf(out + pos, (size_t)room, "\t%f", v);
  }
  // snprintf writes at most room - 1 characters and a NUL: a field of w >=
  // room characters was cut.
  if (w < 0 || w >= room) return -1;
  return pos + w;
}

}  // namespace

extern "C" {

// Formats n rows into out (cap bytes). Returns the bytes written, or -1 if
// the buffer is too small (the caller grows it and calls again).
long long ptmcmc_format_rows(const double* params, const double* lnprob,
                             const double* lnlike, const double* accept,
                             const double* pt_accept, long long n,
                             long long ndim, char* out, long long cap) {
  long long pos = 0;
  for (long long i = 0; i < n; ++i) {
    const double* row = params + i * ndim;
    for (long long k = 0; k < ndim; ++k) {
      pos = field(out, pos, cap, row[k], true, k > 0);
      if (pos < 0) return -1;
    }
    const double tail[4] = {lnprob[i], lnlike[i], accept[i], pt_accept[i]};
    for (double v : tail) {
      pos = field(out, pos, cap, v, false, true);
      if (pos < 0) return -1;
    }
    if (cap - pos < 2) return -1;
    out[pos++] = '\n';
  }
  return pos;
}

}  // extern "C"
