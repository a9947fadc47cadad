"""Device profiles for the PyTorch/CUDA port: :mod:`profile` defines the
frozen :class:`DeviceProfile`, its versioned JSON form and the builtin
registry; :mod:`calibrate` measures a profile on the card (with an on-disk
cache and a deterministic fallback off it)."""
from .calibrate import (cache_key, calibrate, default_cache_dir,
                        load_cached_profile, measure_matmul_flops,
                        measure_stream_bandwidth, measurement_available,
                        resolve_profile, store_cached_profile)
from .profile import (CPU, DEFAULT_PROFILE, H100, HOPPER_MAX_SMEM_PER_BLOCK,
                      LANE_WIDTH, PROFILE_SCHEMA_VERSION, DeviceProfile,
                      ProfileSchemaError, get_profile, register_profile,
                      registered_profiles, torch_device)

__all__ = ["CPU", "DEFAULT_PROFILE", "H100", "HOPPER_MAX_SMEM_PER_BLOCK",
           "LANE_WIDTH", "PROFILE_SCHEMA_VERSION", "DeviceProfile",
           "ProfileSchemaError", "get_profile", "register_profile",
           "registered_profiles", "torch_device",
           "cache_key", "calibrate", "default_cache_dir",
           "load_cached_profile", "measure_matmul_flops",
           "measure_stream_bandwidth", "measurement_available",
           "resolve_profile", "store_cached_profile"]
