from richsem_tpu_torch.config.config import Config, parse_override_options

__all__ = ["Config", "parse_override_options"]
