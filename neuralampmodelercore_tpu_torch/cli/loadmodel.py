"""loadmodel: smoke-test loading a .nam file.

(reference: tools/loadmodel.cpp:6-33; the JAX package's cli/loadmodel.py)

    python -m neuralampmodelercore_tpu_torch.cli.loadmodel MODEL [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nam-loadmodel", description=__doc__)
    ap.add_argument("model")
    ap.add_argument("--device", default="cuda", help="where the model goes (default cuda)")
    args = ap.parse_args(argv)
    import neuralampmodelercore_tpu_torch as nam

    m = nam.load_model(args.model, device=args.device)
    extras = [f"{m.num_params()} params"]
    if m.expected_sample_rate > 0:
        extras.append(f"{m.expected_sample_rate:.0f} Hz")
    print(
        f"Loaded {args.model}: {type(m).__name__} ({m.architecture}), "
        f"{m.num_input_channels} in / {m.num_output_channels} out, " + ", ".join(extras)
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
