from .mobile_presets import generate_mobile_base
from .presets import ARM_PRESETS, generate_arm

__all__ = ["ARM_PRESETS", "generate_arm", "generate_mobile_base"]
