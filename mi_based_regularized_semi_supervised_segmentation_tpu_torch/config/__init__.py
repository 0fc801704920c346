from .manager import ConfigManager, dict_merge, parse_dotted_overrides, load_yaml, DEFAULT_CONFIG_PATH

__all__ = [
    "ConfigManager",
    "dict_merge",
    "parse_dotted_overrides",
    "load_yaml",
    "DEFAULT_CONFIG_PATH",
]
