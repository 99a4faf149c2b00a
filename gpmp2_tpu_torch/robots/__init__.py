from .mobile_presets import MOBILE_PRESETS, generate_mobile_arm, generate_mobile_base
from .presets import ARM_PRESETS, generate_arm

__all__ = ["ARM_PRESETS", "generate_arm", "MOBILE_PRESETS", "generate_mobile_arm",
           "generate_mobile_base"]
