"""Device profiles for the PyTorch/CUDA port (calibration is later work)."""
from .profile import (CPU, DEFAULT_PROFILE, H100, HOPPER_MAX_SMEM_PER_BLOCK,
                      LANE_WIDTH, PROFILE_SCHEMA_VERSION, DeviceProfile,
                      ProfileSchemaError, get_profile, resolve_profile, torch_device)

__all__ = ["CPU", "DEFAULT_PROFILE", "H100", "HOPPER_MAX_SMEM_PER_BLOCK",
           "LANE_WIDTH", "PROFILE_SCHEMA_VERSION", "DeviceProfile",
           "ProfileSchemaError", "get_profile", "resolve_profile", "torch_device"]
