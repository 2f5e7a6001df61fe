from repro_torch.models.transformer import (check_supported, check_trainable,
                                            decode_run, decode_step, encode,
                                            extend, extend_row, forward,
                                            init_cache, init_params, layout,
                                            prefill, prepend_frontend)
from repro_torch.models.kvcache import (cache_bytes, copy_cache,
                                        copy_into_prefix,
                                        copy_prefix_rows, dequantize_kv,
                                        handoff_row, kv_supports_int8,
                                        paste_prefix,
                                        quantize_kv, read_row,
                                        reset_row, select_rows, slice_rows,
                                        snapshot_prefix, truncate_rings,
                                        untruncate_rings, write_row_slice,
                                        write_rows_prefix, write_slot)
from repro_torch.models.params import (from_jax_params,
                                       module_from_state_dict, to_module)

__all__ = ["cache_bytes", "check_supported", "check_trainable",
           "copy_cache", "copy_into_prefix", "copy_prefix_rows", "decode_run", "decode_step", "dequantize_kv",
           "encode", "extend", "extend_row", "forward", "from_jax_params", "handoff_row",
           "init_cache", "init_params", "kv_supports_int8", "layout",
           "module_from_state_dict",
           "paste_prefix", "prefill", "prepend_frontend", "quantize_kv",
           "read_row", "reset_row", "select_rows", "slice_rows",
           "snapshot_prefix", "to_module",
           "truncate_rings", "untruncate_rings", "write_row_slice",
           "write_rows_prefix", "write_slot"]
