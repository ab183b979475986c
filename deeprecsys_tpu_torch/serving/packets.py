"""Request/response packets.

Counterpart of ``deeprecsys_tpu/serving/packets.py``, copied (reference
``utils/packets.py``): ``ServiceRequest`` carries (batch_id, epoch,
arrival_time, batch_size, sub_id, total_sub_batches, exp_packet);
``ServiceResponse`` adds the consumer id, the queue and inference
timestamps and the measured output batch size. ``exp_packet`` marks
warm-up and tuning traffic, excluded from the final metrics.
``tests/test_torch_config.py`` holds the fields and codes equal to the
original's, ``tests/test_torch_runtime.py`` their 64-byte ring form
(``runtime/shm_queue.py``).
"""

from __future__ import annotations

import dataclasses

# Response error codes: a failed request is answered, never dropped, so the
# per-query join still completes. Codes fit one byte (the cpu-mp ring slot).
ERR_OK = 0
ERR_READBACK = 1        # device readback failed after dispatch
ERR_OVER_LADDER = 2     # request exceeds the engine's bucket ladder
ERR_DEADLINE = 3        # deadline expired before dispatch (never executed)
ERR_RELOAD = 4          # checkpoint reload failed (old params keep serving)
ERR_PAYLOAD = 5         # payload shape mismatch vs the engine's model

ERROR_MESSAGES = {
    ERR_OK: None,
    ERR_READBACK: "device readback failed",
    ERR_OVER_LADDER: "request exceeds the engine's compiled bucket ladder",
    ERR_DEADLINE: "deadline expired before dispatch",
    ERR_RELOAD: "checkpoint reload failed; previous params keep serving",
    ERR_PAYLOAD: "payload shape does not match the engine's model",
}

# batch_id of a cpu-mp reload ACK (batch ids count up from 0).
RELOAD_ACK_BATCH_ID = -1


@dataclasses.dataclass(slots=True)
class ServiceRequest:
    batch_id: int = 0
    epoch: int = 0
    batch_size: int = 0
    arrival_time: float = 0.0
    sub_id: int = 0
    total_sub_batches: int = 1
    exp_packet: bool = False
    # Absolute deadline (epoch seconds); 0.0 = none. Engines answer an
    # expired request with ERR_DEADLINE before dispatch.
    deadline: float = 0.0
    # Client features: a models/base.Batch of host numpy arrays with exactly
    # ``batch_size`` rows; the engine runs these rows and returns their
    # scores. None = a load-modeling request (pre-generated rows).
    payload: object = None
    # cpu-mp transport of the same features (a blob-arena slot); -1 = none.
    payload_slot: int = -1


@dataclasses.dataclass(slots=True)
class ServiceResponse:
    consumer_id: int = 0
    epoch: int = 0
    batch_id: int = 0
    batch_size: int = 0
    arrival_time: float = 0.0
    queue_start_time: float = 0.0
    queue_end_time: float = 0.0
    inference_end_time: float = 0.0
    out_batch_size: int = 0
    sub_id: int = 0
    total_sub_batches: int = 1
    exp_packet: bool = False
    error_code: int = ERR_OK
    # (batch_size, out_dim) float32 numpy scores of THIS request's rows;
    # set only when the request carried a payload.
    scores: object = None

    def latency(self) -> float:
        return self.inference_end_time - self.arrival_time

    def error_message(self) -> "str | None":
        return ERROR_MESSAGES.get(self.error_code,
                                  f"engine error {self.error_code}")
