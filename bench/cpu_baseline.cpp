// Single-core C++ baseline for the uplink DSP chain, written to mirror the
// algorithmic structure of the reference transceiver's hot path
// (polyphase resample -> energy detect -> TSC correlate -> peak detect ->
// demodulate), using the same direct (non-FFT) per-sample loops the
// reference uses. This is the "single-core C++ samples/s" denominator for
// bench.py (BASELINE.md targets >10x this per device).
//
// Build: g++ -O3 -march=native -o cpu_baseline cpu_baseline.cpp
#include <chrono>
#include <cmath>
#include <complex>
#include <cstdio>
#include <cstdlib>
#include <random>
#include <vector>

using cf = std::complex<float>;

static const int P = 65, Q = 96, TAPS = 961;
static const int FRAMES = 13;                  // 60 ms block
static const int SYM = FRAMES * 1250;          // 16250 symbols / block
static const int BLOCK_IN = SYM * Q / P;       // 24000 device-rate samples
static const int SLOT = 157;
static const int SLOT_OFF[8] = {0, 157, 313, 469, 625, 782, 938, 1094};

int main(int argc, char **argv) {
  int blocks = argc > 1 ? atoi(argv[1]) : 40;

  // windowed-sinc LPF, cutoff 0.5/96, DC gain P (same design rule as the
  // framework's resampler_lpf)
  std::vector<float> h(TAPS);
  double sum = 0.0;
  for (int i = 0; i < TAPS; i++) {
    double t = i - (TAPS + 1) / 2.0;
    double x = 2.0 * (0.5 / 96.0) * t;
    double ys = (std::fabs(x) < 1e-9) ? 1.0 : std::sin(M_PI * x) / (M_PI * x);
    double yw = 0.53836 - 0.46164 * std::cos(2.0 * M_PI * i / (TAPS + 1));
    h[i] = ys * yw;
    sum += h[i];
  }
  for (auto &v : h) v *= P / sum;

  std::mt19937 rng(7);
  std::normal_distribution<float> g(0.f, 1.f);
  std::vector<cf> in(BLOCK_IN), sym(SYM);
  for (auto &v : in) v = cf(g(rng), g(rng)) * 400.0f;

  // 16-symbol midamble template (rotated +/-1 impulses)
  cf tmpl[16];
  for (int i = 0; i < 16; i++) {
    float phase = (float)M_PI / 2.0f * i;
    float s = (i % 3 == 0) ? 1.f : -1.f;
    tmpl[i] = s * cf(std::cos(phase), std::sin(phase));
  }
  // symbol-rate GMSK reverse rotation table
  std::vector<cf> revrot(SLOT);
  for (int i = 0; i < SLOT; i++)
    revrot[i] = cf(std::cos(-(float)M_PI / 2 * i), std::sin(-(float)M_PI / 2 * i));

  auto sinc = [](float x) { return (std::fabs(x) < 1e-6f) ? 1.0f : std::sin(x) / x; };

  double sink = 0.0;
  auto t0 = std::chrono::steady_clock::now();
  const int i0 = (TAPS - 1) / 2 / Q;
  for (int b = 0; b < blocks; b++) {
    // 1. polyphase resample 65/96 (sigProcLib-style branch loop)
    for (int i = 0; i < SYM; i++) {
      int j = (i0 + i) * Q;
      int branch = j % P;
      int off = j / P;  // (j - branch)/P
      cf acc(0.f, 0.f);
      for (int m = branch, k = off; m < TAPS && k >= 0; m += P, --k)
        if (k < BLOCK_IN) acc += in[k] * h[m];
      sym[i] = acc;
    }
    // 2. per-frame, per-slot burst processing
    for (int f = 0; f < FRAMES; f++) {
      for (int tn = 0; tn < 8; tn++) {
        const cf *burst = &sym[f * 1250 + SLOT_OFF[tn]];
        // energy detect (20 samples)
        float e = 0.f;
        for (int i = 0; i < 20; i++) e += std::norm(burst[i]);
        if (e < 1e-12f) continue;
        // TSC correlate: 36-lag x 16-tap complex correlation
        cf corr[36];
        for (int lag = 0; lag < 36; lag++) {
          cf acc(0.f, 0.f);
          for (int t = 0; t < 16; t++) {
            int idx = 56 + lag + t - 15;
            if (idx >= 0 && idx < SLOT) acc += burst[idx] * std::conj(tmpl[t]);
          }
          corr[lag] = acc;
        }
        // peak detect + early-late sinc refinement (10 halvings)
        int pk = 0;
        float pmax = 0.f;
        for (int i = 0; i < 36; i++)
          if (std::norm(corr[i]) > pmax) { pmax = std::norm(corr[i]); pk = i; }
        auto interp = [&](float ix) {
          cf acc(0.f, 0.f);
          int lo = std::max((int)std::floor(ix) - 10, 0);
          int hi = std::min((int)std::floor(ix) + 11, 35);
          for (int i = lo; i < hi; i++) acc += corr[i] * sinc((float)M_PI * (i - ix));
          return acc;
        };
        float early = pk - 1.f, incr = 0.5f;
        while (incr > 1.f / 1024.f) {
          cf e1 = interp(early), l1 = interp(early + 2.f);
          if (std::abs(e1) < std::abs(l1)) early += incr;
          else early -= incr;
          incr *= 0.5f;
        }
        float toa = early + 1.f;
        // demodulate: 21-tap fractional delay + reverse rotate + slicer
        float frac = toa - std::floor(toa);
        float k21[21];
        for (int i = 0; i < 21; i++) k21[i] = sinc((float)M_PI * (i - 10 - frac));
        for (int i = 0; i < 148; i++) {
          cf acc(0.f, 0.f);
          for (int t = 0; t < 21; t++) {
            int idx = i + (int)std::floor(toa) + t - 10;
            if (idx >= 0 && idx < SLOT) acc += burst[idx] * k21[t];
          }
          acc *= revrot[i];
          float soft = 0.5f * (acc.real() + 1.0f);
          sink += (soft < 0.f) ? 0.f : (soft > 1.f ? 1.f : soft);
        }
      }
    }
  }
  auto t1 = std::chrono::steady_clock::now();
  double secs = std::chrono::duration<double>(t1 - t0).count();
  double sps = (double)blocks * BLOCK_IN / secs;
  printf("{\"samples_per_s\": %.1f, \"seconds\": %.3f, \"blocks\": %d, "
         "\"sink\": %.3f}\n", sps, secs, blocks, sink);
  return 0;
}
