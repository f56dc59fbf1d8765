from .weights import from_jax_variables, init_random_, load_reference_state_dict
