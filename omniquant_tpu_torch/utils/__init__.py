from .convert import from_jax_params, load_packed_npz
