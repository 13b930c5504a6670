"""End-to-end pipeline models. Flagship: the multi-channel Transceiver;
ResidentL1 wraps the fully device-resident duplex (FEC both directions
on-device) as a streaming host API."""

from openbts_ttsou_tpu.models.resident import ResidentL1  # noqa: F401
from openbts_ttsou_tpu.models.transceiver import Transceiver  # noqa: F401
