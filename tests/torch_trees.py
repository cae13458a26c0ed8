"""Tiny on-disk dataset trees for the port's CPU tests: MCR PNG pairs with
their path lists (the SID layout comes from the port's
``data.synthetic.write_sid_tree``)."""

import os

import numpy as np

MCR_LISTS = "Mono_Colored_RAW_Paired_DATASET/random_path_list"


def write_mcr_tree(root, shapes, rng):
    """PNG pairs named as MCR's files (``[-23:-20]`` image number, ``[-8:-4]``
    hex exposure) and ``random_path_list/{train,test}/{split}_{c,rgb}_path.npy``
    lists; ``shapes`` maps "train" / "test" to the frames' (H, W). Returns
    (raws, rgbs) per split."""
    import imageio.v2 as imageio

    out = {}
    for split, frames in shapes.items():
        os.makedirs(os.path.join(root, MCR_LISTS, split), exist_ok=True)
        raws, rgbs = [], []
        for k, (h, w) in enumerate(frames):
            # image numbers below and above 500 take the two GT exposures
            num, expo = (7 + k, 0x00FF) if k % 2 == 0 else (612 + k, 0x0040)
            name = f"C0{num:04d}_48mp_0x8_0x{expo:04x}.png"
            raw_p = os.path.join(root, f"{split}_raw_{name}")
            rgb_p = os.path.join(root, f"{split}_rgb_{name}")
            imageio.imwrite(raw_p, rng.integers(0, 256, (h, w), dtype=np.uint8))
            imageio.imwrite(rgb_p, rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            raws.append(raw_p)
            rgbs.append(rgb_p)
        lists = os.path.join(root, MCR_LISTS, split, split)
        np.save(f"{lists}_c_path.npy", np.array(raws, dtype=object), allow_pickle=True)
        np.save(f"{lists}_rgb_path.npy", np.array(rgbs, dtype=object), allow_pickle=True)
        out[split] = (raws, rgbs)
    return out
