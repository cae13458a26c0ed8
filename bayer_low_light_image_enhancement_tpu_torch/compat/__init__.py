from bayer_low_light_image_enhancement_tpu_torch.compat.jax_params import (
    state_dict_from_jax,
    transformer_block_state_dict,
    wfb_state_dict_from_jax,
)

__all__ = ["state_dict_from_jax", "transformer_block_state_dict", "wfb_state_dict_from_jax"]
