// Golden-vector generator: drives the REFERENCE sigProcLib (compiled
// from /root/reference via include paths; nothing copied into this
// repo) through the canonical scenarios and prints the numerical
// outputs for the parity test suite to compare against the
// framework's JAX kernels. Runs the burst-level scenario at sps=1 (the
// 52M compile default) and again at sps=4 (sigProcLibTest geometry);
// sps=4 lines carry an "SPS4_" prefix.
#include "sigProcLib.h"
#include "GSMCommon.h"
#include <cstdio>
#include <cmath>
#include <cstring>

using namespace GSM;

static void dumpVec(const char *name, const signalVector &v) {
  printf("%s %zu", name, (size_t)v.size());
  for (size_t i = 0; i < v.size(); i++)
    printf(" %.6g %.6g", v[i].real(), v[i].imag());
  printf("\n");
}

static void dumpSoft(const char *name, const SoftVector &v) {
  printf("%s %zu", name, (size_t)v.size());
  for (size_t i = 0; i < v.size(); i++) printf(" %.6g", v[i]);
  printf("\n");
}

static void burstScenario(int sps, const char *prefix) {
  char name[64];
  sigProcLibSetup(sps);
  signalVector *pulse = generateGSMPulse(2, sps);
  snprintf(name, sizeof name, "%sPULSE", prefix);
  dumpVec(name, *pulse);

  // 1. modulated normal burst (TSC 0, fixed payload)
  BitVector burstBits(148);
  for (unsigned i = 0; i < 148; i++) burstBits[i] = (i * 7 + 3) % 5 < 2;
  gTrainingSequence[0].copyToSegment(burstBits, 61);
  signalVector *mod = modulateBurst(burstBits, *pulse, 9, sps);
  snprintf(name, sizeof name, "%sMODBURST", prefix);
  dumpVec(name, *mod);

  // 2. midamble + RACH templates
  generateMidamble(*pulse, sps, 0);
  generateRACHSequence(*pulse, sps);

  // 3. TSC detection on the clean burst
  complex ampl;
  float toa;
  bool ok = analyzeTrafficBurst(*mod, 0, 3.0, sps, &ampl, &toa, false,
                                NULL, NULL);
  snprintf(name, sizeof name, "%sTSCDET", prefix);
  printf("%s %d %.6g %.6g %.6g\n", name, (int)ok, ampl.real(),
         ampl.imag(), toa);

  // 4. demodulated soft bits
  SoftVector *soft = demodulateBurst(*mod, *pulse, sps, ampl, toa);
  snprintf(name, sizeof name, "%sDEMOD", prefix);
  dumpSoft(name, *soft);

  // 5. RACH burst + detection
  BitVector rachBits(148);
  rachBits.zero();
  for (unsigned i = 0; i < 8; i++) rachBits[i] = i % 2;
  gRACHSynchSequence.copyToSegment(rachBits, 8);
  signalVector *rach = modulateBurst(rachBits, *pulse, 9, sps);
  complex ra;
  float rtoa;
  bool rok = detectRACHBurst(*rach, 5.0, sps, &ra, &rtoa);
  snprintf(name, sizeof name, "%sRACHDET", prefix);
  printf("%s %d %.6g %.6g %.6g\n", name, (int)rok, ra.real(), ra.imag(),
         rtoa);

  // 5b. polyphase resampling of the modulated burst through both LPFs
  // (the radioInterface 64M path: up 96/65 with the 651-tap LPF, back
  // down 65/96 with the 961-tap LPF — sigProcLibTest.cpp:83-111);
  // sps-independent, emitted only for the sps=1 pass
  if (sps == 1) {
    signalVector *upLPF = createLPF(1.0f / 96.0f, 651, 96);
    dumpVec("LPF651", *upLPF);
    signalVector *up = polyphaseResampleVector(*mod, 96, 65, upLPF);
    dumpVec("RESAMPUP", *up);
    signalVector *dnLPF = createLPF(1.0f / 96.0f, 961, 65);
    dumpVec("LPF961", *dnLPF);
    signalVector *dn = polyphaseResampleVector(*up, 65, 96, dnLPF);
    dumpVec("RESAMPDN", *dn);
  }

  // 6. DFE design on a fixed channel (sps-independent; sps=1 only)
  if (sps == 1) {
    signalVector chan(6);
    chan[0] = complex(1.0, 0.0);
    chan[1] = complex(0.4, 0.1);
    chan[2] = complex(0.1, -0.05);
    signalVector *ff = NULL, *fb = NULL;
    designDFE(chan, 100.0, 7, &ff, &fb);
    dumpVec("DFEFF", *ff);
    dumpVec("DFEFB", *fb);
  }

  sigProcLibDestroy();
}

int main() {
  burstScenario(1, "");
  burstScenario(4, "SPS4_");
  return 0;
}
