from .weights import (from_jax_quantized, from_jax_variables, init_random_,
                      init_training_, load_reference_state_dict)
