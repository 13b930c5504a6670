"""The DSP kernel library (reference: Transceiver*/sigProcLib.{h,cpp}).

Every kernel is batched over arbitrary leading axes (canonically
``[channel, burst]``), jit-friendly (static shapes, no data-dependent
Python control flow), and works in float32/complex64. Hot paths are
(grouped) convolutions and matrix products.
"""

from openbts_ttsou_tpu.ops.fir import (  # noqa: F401
    convolve,
    design_lpf,
    polyphase_resample,
)
from openbts_ttsou_tpu.ops.gmsk import (  # noqa: F401
    gsm_pulse,
    modulate_burst,
    demodulate_burst,
    rotation,
    vector_slicer,
)
from openbts_ttsou_tpu.ops import signal  # noqa: F401
