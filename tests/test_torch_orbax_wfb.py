"""The orbax -> port checkpoint converter on a JAX RawFormer-WFB-48 train
state (``test_torch_orbax.check_converted``): the JAX eval CLI on the orbax
directory against the port's on the converted one, the converted weights'
forward against the JAX apply at the repo's 1e-4. Its own file, so that
xdist's ``--dist loadfile`` runs it beside the RawFormer-S case: most of its
~2 min is the JAX eval CLI's op-by-op init of WFB-48."""

import torch

from test_torch_orbax import check_converted, sid_tree  # noqa: F401

torch.set_num_threads(2)


def test_converted_wfb_checkpoint_serves_as_jax(sid_tree, tmp_path, monkeypatch,  # noqa: F811
                                                capsys):
    check_converted("rawformer_wfb", sid_tree, tmp_path, monkeypatch, capsys)
