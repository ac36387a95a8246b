"""Run chosen phases of a checkout's ``chip_smoke.py`` on the GPU, so that two
checkouts' phase lines (images/s, tok/s, ms per step) can be compared within
one machine's run.

    cd CHECKOUT && python3 /path/to/chip_phases.py resnet_path w4a4_lm_path digits_path

The script imports ``chip_smoke.py`` and the port from the current directory,
not from its own, builds that checkout's kernels, prints the card's name and
power limit, then calls each named phase function of ``chip_smoke.py`` with
that line and prints its time. It checks what each phase checks and exits
non-zero where one fails. It needs one card.
"""

import os
import sys
import time

sys.path.insert(0, os.getcwd())


def main(names) -> None:
    import chip_smoke
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this script needs a CUDA GPU")
    from pytorch_quantize_impls_tpu_torch.kernels import _build

    card = chip_smoke.card_line()
    print(card, flush=True)
    t = time.perf_counter()
    _build.build()
    print(f"built in {time.perf_counter() - t:.1f} s", flush=True)
    for name in names:
        t = time.perf_counter()
        getattr(chip_smoke, name)(card)
        print(f"phase {name}: {time.perf_counter() - t:.1f} s  [{os.getcwd()}]", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
