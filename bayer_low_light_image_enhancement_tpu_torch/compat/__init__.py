from bayer_low_light_image_enhancement_tpu_torch.compat.jax_params import (
    flca_state_dict_from_jax,
    multilvl_flca_state_dict_from_jax,
    state_dict_from_jax,
    transformer_block_state_dict,
    truecolor_state_dict_from_jax,
    wfb_state_dict_from_jax,
)

__all__ = [
    "flca_state_dict_from_jax",
    "multilvl_flca_state_dict_from_jax",
    "state_dict_from_jax",
    "transformer_block_state_dict",
    "truecolor_state_dict_from_jax",
    "wfb_state_dict_from_jax",
]
