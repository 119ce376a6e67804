from .registry import (ARCHS, all_cells, cell_applicable, get_config,
                       get_smoke_config, get_trace_config, input_specs)

__all__ = ["ARCHS", "all_cells", "cell_applicable", "get_config",
           "get_smoke_config", "get_trace_config", "input_specs"]
