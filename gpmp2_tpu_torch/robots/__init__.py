from .presets import ARM_PRESETS, generate_arm

__all__ = ["ARM_PRESETS", "generate_arm"]
