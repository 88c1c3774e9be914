"""AdamW and gradient compression (counterpart of ``repro.optim``)."""

from .adamw import (AdamWConfig, apply_updates, global_norm, init_opt_state,
                    lr_at, opt_state_specs)
from .compression import compress_int8, compressed_psum, decompress_int8

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_opt_state",
           "lr_at", "opt_state_specs", "compress_int8", "decompress_int8", "compressed_psum"]
