from .base import ALL_METHODS, PEFT_METHODS, PeftConfig, init_peft, make_hooks

__all__ = ["ALL_METHODS", "PEFT_METHODS", "PeftConfig", "init_peft", "make_hooks"]
