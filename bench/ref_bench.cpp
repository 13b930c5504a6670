// CPU baseline measured on the REAL reference sigProcLib.
//
// Unlike bench/cpu_baseline.cpp (a hand-written mirror of the hot path,
// kept as a fallback when /root/reference is absent), this harness
// compiles the reference's own Transceiver/sigProcLib.cpp and times the
// actual uplink chain the transceiver runs per received block:
//
//   polyphaseResampleVector (961-tap LPF, 65/96 down to symbol rate)
//     -> per-slot energyDetect
//     -> analyzeTrafficBurst (TSC correlate + peakDetect)
//     -> demodulateBurst (soft bits)
//
// mirroring Transceiver/radioInterface.cpp:197-260 (pullBuffer resample)
// and Transceiver52M/Transceiver.cpp:268-408 (pullRadioVector), with the
// same block geometry as the framework bench (13 frames / 60 ms blocks,
// 1250 symbols per frame, 157/156/156/156 slot framing) so the
// samples/s number is the honest denominator for bench.py's
// vs_baseline. Every slot carries a real modulated TSC-0 burst so the
// chain takes the same path (detection succeeds -> demod runs) that the
// device bench exercises.
//
// Build (see golden/README.md for the include recipe):
//   g++ -O3 -march=native -include unistd.h \
//       -I/root/reference/CommonLibs -I/root/reference/Transceiver \
//       -I/root/reference/GSM -o ref_bench ref_bench.cpp \
//       /root/reference/Transceiver/sigProcLib.cpp \
//       /root/reference/GSM/GSMCommon.cpp \
//       /root/reference/CommonLibs/{BitVector,Logger,Sockets,Threads,Timeval,Configuration}.cpp \
//       -lpthread
#include "sigProcLib.h"
#include "GSMCommon.h"
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>

using namespace GSM;

static const int SPS = 1;
static const int FRAMES = 13;              // one 60 ms block
static const int SYM_PER_FRAME = 1250;     // 157+156+156+156 twice
static const int SYM = FRAMES * SYM_PER_FRAME;
static const int BLOCK_IN = SYM * 96 / 65; // 24000 device-rate samples
static const int SLOT_OFF[8] = {0, 157, 313, 469, 625, 782, 938, 1094};
static const int SLOT_LEN[8] = {157, 156, 156, 156, 157, 156, 156, 156};

int main(int argc, char **argv) {
  int blocks = argc > 1 ? atoi(argv[1]) : 60;

  sigProcLibSetup(SPS);
  signalVector *pulse = generateGSMPulse(2, SPS);
  generateMidamble(*pulse, SPS, 0);
  generateRACHSequence(*pulse, SPS);

  // The radioInterface's two LPF tables (Transceiver/radioInterface.cpp:
  // 130-133 requests 651 taps for send, 218-222 requests 961 for receive).
  signalVector *sendLPF = createLPF(1.0f / 96.0f, 651, 96);
  signalVector *rcvLPF = createLPF(1.0f / 96.0f, 961, 65);

  // Build one block of device-rate input OUTSIDE the timed region:
  // a TSC-0 normal burst in every slot at symbol rate, upsampled 96/65
  // exactly as the transmit side would produce it.
  BitVector bits(148);
  for (unsigned i = 0; i < 148; i++) bits[i] = (i * 7 + 3) % 5 < 2;
  gTrainingSequence[0].copyToSegment(bits, 61);
  signalVector *burst = modulateBurst(bits, *pulse, 9, SPS);

  signalVector symIn(SYM);
  symIn.fill(complex(0, 0));
  for (int f = 0; f < FRAMES; f++)
    for (int tn = 0; tn < 8; tn++) {
      int off = f * SYM_PER_FRAME + SLOT_OFF[tn];
      for (unsigned i = 0; i < burst->size() && (int)i < SLOT_LEN[tn]; i++)
        symIn[off + i] = (*burst)[i] * complex(400.0, 0.0);
    }
  signalVector *devIn = polyphaseResampleVector(symIn, 96, 65, sendLPF);
  // Trim/pad to the nominal device-rate block length.
  signalVector input(BLOCK_IN);
  input.fill(complex(0, 0));
  for (int i = 0; i < BLOCK_IN && i < (int)devIn->size(); i++)
    input[i] = (*devIn)[i];

  double sink = 0.0;
  long demods = 0, detects = 0;
  auto t0 = std::chrono::steady_clock::now();
  for (int b = 0; b < blocks; b++) {
    // HOT LOOP 1: the 961-tap 65/96 polyphase resample
    // (Transceiver/radioInterface.cpp:218-222, sigProcLib.cpp:1154-1210)
    signalVector *rx = polyphaseResampleVector(input, 65, 96, rcvLPF);

    for (int f = 0; f < FRAMES; f++) {
      for (int tn = 0; tn < 8; tn++) {
        int off = f * SYM_PER_FRAME + SLOT_OFF[tn];
        if (off + 157 > (int)rx->size()) continue;
        // The transceiver receives each slot as its own radioVector
        // (radioInterface.cpp:275-292 copies the slice) — include the copy.
        signalVector vec(rx->begin(), off, SLOT_LEN[tn]);
        signalVector slot(vec);

        // Transceiver.cpp:294-303
        if (!energyDetect(slot, 20 * SPS, 5.0f)) continue;

        // HOT LOOP 2: TSC correlate + peak detect
        // (Transceiver.cpp:324-348; sigProcLib.cpp:935-1037)
        complex amp;
        float toa;
        bool ok = analyzeTrafficBurst(slot, 0, 3.0f, SPS, &amp, &toa,
                                      false, NULL, NULL);
        if (!ok) continue;
        detects++;

        // Transceiver.cpp:381-395
        SoftVector *soft = demodulateBurst(slot, *pulse, SPS, amp, toa);
        if (soft) {
          sink += (*soft)[77];
          demods++;
          delete soft;
        }
      }
    }
    delete rx;
  }
  auto t1 = std::chrono::steady_clock::now();
  double secs = std::chrono::duration<double>(t1 - t0).count();
  double sps = (double)blocks * BLOCK_IN / secs;

  // DUPLEX: the transceiver's full per-block work — transmit side
  // (modulateBurst per slot + tx scale + 651-tap 96/65 resample,
  // driveTransmitFIFO -> pushBuffer, Transceiver52M/Transceiver.cpp:
  // 103-181 + Transceiver/radioInterface.cpp:123-186) PLUS the uplink
  // chain above. Denominator stays device-rate samples per block (a
  // duplex-processed sample counts once), matching bench.py's duplex
  // metric.
  double sink2 = 0.0;
  auto t2 = std::chrono::steady_clock::now();
  for (int b = 0; b < blocks; b++) {
    // tx leg
    signalVector txSym(SYM);
    txSym.fill(complex(0, 0));
    for (int f = 0; f < FRAMES; f++)
      for (int tn = 0; tn < 8; tn++) {
        signalVector *m = modulateBurst(bits, *pulse, 9, SPS);
        scaleVector(*m, complex(13500.0, 0.0));
        int off = f * SYM_PER_FRAME + SLOT_OFF[tn];
        for (unsigned i = 0; i < m->size() && (int)i < SLOT_LEN[tn]; i++)
          txSym[off + i] = (*m)[i];
        delete m;
      }
    signalVector *txDev = polyphaseResampleVector(txSym, 96, 65, sendLPF);
    sink2 += (*txDev)[100].real();
    delete txDev;

    // rx leg (same chain as the uplink loop)
    signalVector *rx = polyphaseResampleVector(input, 65, 96, rcvLPF);
    for (int f = 0; f < FRAMES; f++) {
      for (int tn = 0; tn < 8; tn++) {
        int off = f * SYM_PER_FRAME + SLOT_OFF[tn];
        if (off + 157 > (int)rx->size()) continue;
        signalVector vec(rx->begin(), off, SLOT_LEN[tn]);
        signalVector slot(vec);
        if (!energyDetect(slot, 20 * SPS, 5.0f)) continue;
        complex amp;
        float toa;
        if (!analyzeTrafficBurst(slot, 0, 3.0f, SPS, &amp, &toa,
                                 false, NULL, NULL)) continue;
        SoftVector *soft = demodulateBurst(slot, *pulse, SPS, amp, toa);
        if (soft) {
          sink2 += (*soft)[77];
          delete soft;
        }
      }
    }
    delete rx;
  }
  auto t3 = std::chrono::steady_clock::now();
  double secs2 = std::chrono::duration<double>(t3 - t2).count();
  double sps_duplex = (double)blocks * BLOCK_IN / secs2;

  // DOWNLINK only: the tx leg in isolation.
  double sink3 = 0.0;
  auto t4 = std::chrono::steady_clock::now();
  for (int b = 0; b < blocks; b++) {
    signalVector txSym(SYM);
    txSym.fill(complex(0, 0));
    for (int f = 0; f < FRAMES; f++)
      for (int tn = 0; tn < 8; tn++) {
        signalVector *m = modulateBurst(bits, *pulse, 9, SPS);
        scaleVector(*m, complex(13500.0, 0.0));
        int off = f * SYM_PER_FRAME + SLOT_OFF[tn];
        for (unsigned i = 0; i < m->size() && (int)i < SLOT_LEN[tn]; i++)
          txSym[off + i] = (*m)[i];
        delete m;
      }
    signalVector *txDev = polyphaseResampleVector(txSym, 96, 65, sendLPF);
    sink3 += (*txDev)[100].real();
    delete txDev;
  }
  auto t5 = std::chrono::steady_clock::now();
  double secs3 = std::chrono::duration<double>(t5 - t4).count();
  double sps_downlink = (double)blocks * BLOCK_IN / secs3;

  printf("{\"samples_per_s\": %.1f, \"samples_per_s_duplex\": %.1f, "
         "\"samples_per_s_downlink\": %.1f, "
         "\"seconds\": %.3f, \"seconds_duplex\": %.3f, \"blocks\": %d, "
         "\"detects\": %ld, \"demods\": %ld, \"sink\": %.3f, "
         "\"harness\": \"reference sigProcLib\"}\n",
         sps, sps_duplex, sps_downlink, secs, secs2, blocks, detects,
         demods, sink + sink2 + sink3);

  delete devIn;
  delete burst;
  delete sendLPF;
  delete rcvLPF;
  delete pulse;
  sigProcLibDestroy();
  return 0;
}
