"""openbts_ttsou_tpu — a GSM software-transceiver framework on one accelerator.

A from-scratch JAX/XLA re-design of the capabilities of OpenBTS
2.6TRUNK (ttsou fork). The physical layer (the reference's `sigProcLib` +
`Transceiver`) is rebuilt as batched, jit-compiled array programs over a
`[channel, timeslot, sample]` layout, sharded across device meshes;
the bit-level GSM stack (FEC, LAPDm, L3), and the surrounding runtime
(config, logging, transport planes) are provided as host-side components
speaking the same three logical planes (burst data / control / clock) as
the reference's UDP protocol.

Subpackages
-----------
- ``utils``    — foundation: GSM time, constants, config, logging, bit utils
  (reference: CommonLibs/, GSM/GSMCommon.*)
- ``ops``      — the DSP kernel library (reference: Transceiver*/sigProcLib.*)
- ``gsm``      — FEC / TDMA / burst+frame formats (reference: GSM/)
- ``trx``      — the transceiver engine (reference: Transceiver*/Transceiver.*)
- ``models``   — end-to-end pipeline models (flagship: `Transceiver` pipeline)
- ``parallel`` — meshes, sharding, halo exchange (replaces threads/UDP with
  XLA collectives)
"""

__version__ = "0.1.0"
