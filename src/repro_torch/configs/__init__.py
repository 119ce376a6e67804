from .registry import (ARCHS, get_config, get_smoke_config,
                       get_trace_config)

__all__ = ["ARCHS", "get_config", "get_smoke_config", "get_trace_config"]
