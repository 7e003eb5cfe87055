from .env import env_flag, timing_options_from_env

__all__ = ["env_flag", "timing_options_from_env"]
