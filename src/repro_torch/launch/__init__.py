"""Entry points (twin of ``repro/launch``): ``serve``."""
