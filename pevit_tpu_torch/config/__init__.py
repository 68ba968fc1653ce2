from .cfg_node import CfgNode
from .defaults import get_default_config

__all__ = ["CfgNode", "get_default_config"]
