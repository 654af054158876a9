"""Run a forward on EVERY assigned architecture (reduced config) and apply
the family-appropriate InvarExplore adapter to each — demonstrates the
technique as a first-class feature across dense / MoE / SSM families.

    PYTHONPATH=src python -m repro_torch.examples.multiarch_smoke [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.search import make_adapter
from repro_torch.device import resolve_device
from repro_torch.models.frontends import stub_audio_frames, stub_vision_embeds
from repro_torch.models.model import forward, init_params, lm_loss


def main(argv=None):
    """Returns one (arch, loss, adapter class name, n_units, the shared
    phase's adapter class name or None) per architecture."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rows = []
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        gen = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, gen, device=dev)
        kw = {}
        if cfg.frontend == "vision":
            kw["vision_embeds"] = stub_vision_embeds(gen, cfg, 2, 8,
                                                     device=dev)
        if cfg.is_enc_dec:
            kw["enc_embeds"] = stub_audio_frames(gen, cfg, 2, 16, device=dev)
        tokens = torch.randint(0, cfg.vocab_size, (2, 32), generator=gen,
                               device=dev)
        loss = float(lm_loss(forward(params, cfg, tokens, **kw)[:, -32:],
                             tokens, cfg.vocab_size))

        adapter = make_adapter(cfg)
        note = f"adapter={type(adapter).__name__} units={adapter.n_units}"
        shared = None
        if cfg.block_pattern == "hybrid":
            shared = type(make_adapter(cfg, phase="shared")).__name__
            note += f" + {shared} (two-phase)"
        print(f"{arch:24s} loss={loss:.3f}  {note}")
        rows.append((arch, loss, type(adapter).__name__, adapter.n_units,
                     shared))
    print("\nall architectures OK")
    return rows


if __name__ == "__main__":
    main()
