// Native ESS engine: batched FFT autocorrelation + Geyer initial-monotone
// effective sample size.
//
// The reference computes ESS per-series in interpreted MATLAB/NumPy
// (code/tools.py:21-74).  At framework scale the diagnostics input is
// (chains x samples x params) with millions of series; this engine runs
// the same estimator (alias-free "exact" nFFT = 2*nextpow2 variant, cf.
// diagnostics/ess.py) as native code threaded over series.
//
// Exposed via ctypes (no pybind11 in the image); see
// riemannhamiltonianmontecarlo/diagnostics/native.py.

#include <cmath>
#include <complex>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

using cd = std::complex<double>;

// Iterative radix-2 Cooley-Tukey FFT, in place.  n must be a power of 2.
void fft_pow2(cd* a, std::size_t n, bool inverse) {
  // bit reversal
  for (std::size_t i = 1, j = 0; i < n; ++i) {
    std::size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (std::size_t len = 2; len <= n; len <<= 1) {
    const double ang = (inverse ? 2.0 : -2.0) * M_PI / static_cast<double>(len);
    const cd wlen(std::cos(ang), std::sin(ang));
    for (std::size_t i = 0; i < n; i += len) {
      cd w(1.0, 0.0);
      for (std::size_t k = 0; k < len / 2; ++k) {
        const cd u = a[i + k];
        const cd v = a[i + k + len / 2] * w;
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
        w *= wlen;
      }
    }
  }
  if (inverse) {
    const double inv_n = 1.0 / static_cast<double>(n);
    for (std::size_t i = 0; i < n; ++i) a[i] *= inv_n;
  }
}

std::size_t next_pow2(std::size_t n) {
  std::size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Geyer initial-monotone ESS for one demeaned series (semantics of
// code/tools.py:32-74 with alias-free ACF).
double geyer_ess_one(const double* x, std::size_t n, std::size_t max_lag,
                     std::vector<cd>& buf) {
  const std::size_t nfft = 2 * next_pow2(n);
  buf.assign(nfft, cd(0.0, 0.0));
  double mean = 0.0;
  for (std::size_t i = 0; i < n; ++i) mean += x[i];
  mean /= static_cast<double>(n);
  for (std::size_t i = 0; i < n; ++i) buf[i] = cd(x[i] - mean, 0.0);

  fft_pow2(buf.data(), nfft, false);
  for (std::size_t i = 0; i < nfft; ++i) buf[i] *= std::conj(buf[i]);
  fft_pow2(buf.data(), nfft, true);

  const double acf0 = buf[0].real();
  if (acf0 <= 0.0) return static_cast<double>(n);  // constant series

  // Pair sums Gamma_j = rho_{2j} + rho_{2j+1}, running-min monotonized,
  // summed while positive (prefix property after monotonization).
  const std::size_t half = (max_lag + 1) / 2;
  double mono_sum = 0.0;
  double running_min = 1e300;
  for (std::size_t j = 0; j < half; ++j) {
    const double g =
        (buf[2 * j].real() + buf[2 * j + 1].real()) / acf0;
    running_min = std::min(running_min, g);
    if (running_min <= 0.0) break;
    mono_sum += running_min;
  }
  double mono_est = -1.0 + 2.0 * mono_sum;  // -rho_0 + 2 sum Gamma^+
  if (mono_est < 1.0) mono_est = 1.0;
  return static_cast<double>(n) / mono_est;
}

}  // namespace

extern "C" {

// samples: (n_series, n_samples) row-major; out: (n_series).
// Returns 0 on success.
int geyer_ess_batch(const double* samples, int64_t n_series, int64_t n_samples,
                    int64_t max_lag, double* out, int num_threads) {
  if (n_series <= 0 || n_samples <= 1) return 1;
  if (max_lag <= 0 || max_lag >= n_samples) max_lag = n_samples - 1;
  const int hw = static_cast<int>(std::thread::hardware_concurrency());
  int threads = num_threads > 0 ? num_threads : (hw > 0 ? hw : 4);
  if (threads > n_series) threads = static_cast<int>(n_series);

  auto worker = [&](int64_t begin, int64_t end) {
    std::vector<cd> buf;
    for (int64_t s = begin; s < end; ++s) {
      out[s] = geyer_ess_one(samples + s * n_samples,
                             static_cast<std::size_t>(n_samples),
                             static_cast<std::size_t>(max_lag), buf);
    }
  };

  std::vector<std::thread> pool;
  const int64_t per = (n_series + threads - 1) / threads;
  for (int t = 0; t < threads; ++t) {
    const int64_t begin = t * per;
    const int64_t end = std::min<int64_t>(begin + per, n_series);
    if (begin >= end) break;
    pool.emplace_back(worker, begin, end);
  }
  for (auto& th : pool) th.join();
  return 0;
}

}  // extern "C"
