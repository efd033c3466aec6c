"""The 10 assigned architectures — aggregator.

``supports_long`` implements the sub-quadratic rule for long_500k
(see DESIGN.md): SSM/hybrid/windowed archs run it; pure full-attention
archs skip it.
"""

from .olmo_1b import CONFIG as OLMO_1B
from .phi4_mini_3_8b import CONFIG as PHI4_MINI
from .llama3_2_1b import CONFIG as LLAMA32_1B
from .gemma3_27b import CONFIG as GEMMA3_27B
from .mixtral_8x7b import CONFIG as MIXTRAL_8X7B
from .llama4_maverick_400b_a17b import CONFIG as LLAMA4_MAVERICK
from .phi_3_vision_4_2b import CONFIG as PHI3_VISION
from .whisper_tiny import CONFIG as WHISPER_TINY
from .recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B
from .mamba2_370m import CONFIG as MAMBA2_370M

ALL = [OLMO_1B, PHI4_MINI, LLAMA32_1B, GEMMA3_27B, MIXTRAL_8X7B, LLAMA4_MAVERICK, PHI3_VISION, WHISPER_TINY, RECURRENTGEMMA_2B, MAMBA2_370M]
