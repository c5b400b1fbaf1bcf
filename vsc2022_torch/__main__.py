"""Umbrella entry point of the PyTorch/CUDA port: ``python -m
vsc2022_torch <command> ...`` (the JAX package's commands, routed to the
port's modules).

Each command is also runnable as ``python -m vsc2022_torch.<module>``.
``--help`` exits 0; no command, or an unknown one, prints the list and
exits 2.
"""

import sys

COMMANDS = {
    "inference": ("vsc2022_torch.inference.cli", "Extract frame descriptors"),
    "sscd-baseline": (
        "vsc2022_torch.baseline.sscd_baseline",
        "SSCD/DINO matching pipeline",
    ),
    "dns-index": ("vsc2022_torch.baseline.dns_index", "DnS student indexing"),
    "dns-baseline": (
        "vsc2022_torch.baseline.dns_baseline",
        "DnS two-stage matching pipeline",
    ),
    "adapt-model": (
        "vsc2022_torch.baseline.adapt_model",
        "Convert torch weights to Flax npz checkpoints",
    ),
    "train": ("vsc2022_torch.train.cli", "Self-supervised descriptor training"),
    "serve": (
        "vsc2022_torch.retrieval.serve",
        "Resident retrieval server (corpus staged once)",
    ),
    "parity": (
        "vsc2022_torch.parity",
        "One-command real-data parity dress rehearsal",
    ),
}


def main(argv):
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print("usage: python -m vsc2022_torch <command> [args]\n\ncommands:")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:15s} {desc}")
        print(
            "\n(the eval CLIs: python -m vsc2022_torch.descriptor_eval and "
            "python -m vsc2022_torch.matching_eval)"
        )
        return 0 if argv and argv[0] in ("-h", "--help") else 2

    import importlib
    import logging

    logging.basicConfig(
        format="%(asctime)s %(levelname)-8s %(message)s",
        level=logging.INFO,
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    module = importlib.import_module(COMMANDS[argv[0]][0])
    module.main(module.parser.parse_args(argv[1:]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
