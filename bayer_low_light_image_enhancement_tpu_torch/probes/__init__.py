"""Probe ladders of the apply pass (P): ``floor`` holds the wrappers, their
plain twins and the ladder runners; ``python -m
bayer_low_light_image_enhancement_tpu_torch.probes`` runs them on the card."""
