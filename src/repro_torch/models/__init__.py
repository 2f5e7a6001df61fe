from repro_torch.models.transformer import (check_supported, decode_run,
                                            decode_step, extend, extend_row,
                                            init_cache, init_params, layout)
from repro_torch.models.kvcache import (cache_bytes, copy_into_prefix,
                                        dequantize_kv, quantize_kv, read_row,
                                        reset_row, select_rows, slice_rows,
                                        truncate_rings, untruncate_rings,
                                        write_row_slice, write_rows_prefix)
from repro_torch.models.params import (from_jax_params,
                                       module_from_state_dict, to_module)

__all__ = ["cache_bytes", "check_supported", "copy_into_prefix",
           "decode_run", "decode_step", "dequantize_kv", "extend",
           "extend_row", "from_jax_params", "init_cache", "init_params",
           "layout", "module_from_state_dict", "quantize_kv",
           "read_row", "reset_row", "select_rows", "slice_rows", "to_module",
           "truncate_rings", "untruncate_rings", "write_row_slice",
           "write_rows_prefix"]
