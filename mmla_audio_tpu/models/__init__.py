from mmla_audio_tpu.models.overlap import OverlapResBLSTM
from mmla_audio_tpu.models.speaker import SpeakerResBLSTM, l2_penalty

__all__ = [
    "OverlapResBLSTM",
    "SpeakerResBLSTM",
    "l2_penalty",
]
