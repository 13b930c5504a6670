"""Engine state checkpoint/resume.

The reference has no signal-state checkpointing (SURVEY.md §5): a
transceiver restart is cold with a random start FN
(Transceiver.cpp:48). Because this engine keeps ALL stream state in one
explicit `TrxState` pytree, a checkpoint is just that pytree plus the
static config — save it, reload it, and the stream resumes mid-call
with its adaptive thresholds, channel estimates and filler tables
intact.
"""

from __future__ import annotations

import json

import jax
import numpy as np

from openbts_ttsou_tpu.trx import engine as eng

_FIELDS = list(eng.TrxState._fields)


def save_state(path: str, cfg: eng.TrxConfig, state: eng.TrxState) -> None:
    arrays = {name: jax.device_get(getattr(state, name)) for name in _FIELDS}
    arrays["__config__"] = np.frombuffer(
        json.dumps(cfg._asdict()).encode(), np.uint8)
    np.savez(path, **arrays)


def load_state(path: str) -> tuple[eng.TrxConfig, eng.TrxState]:
    data = np.load(path)
    cfg = eng.TrxConfig(**json.loads(bytes(data["__config__"]).decode()))
    state = eng.TrxState(**{name: jax.device_put(data[name])
                            for name in _FIELDS})
    return cfg, state
