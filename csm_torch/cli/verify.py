"""``csm-torch-verify`` — check a WAV file for the CSM watermark.

Exit code 0 when the key is found, 1 when it is not.  ``--device`` picks
the card (the default) or the CPU.

    python -m csm_torch.cli.verify audio.wav --watermark-ckpt silentcipher/
"""

from __future__ import annotations

import argparse
import sys

from csm_torch.cli.common import add_device_flag


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Check audio for the CSM watermark")
    p.add_argument("audio_path", type=str)
    p.add_argument("--watermark-ckpt", type=str, default=None,
                   help="Directory with silentcipher torch checkpoints")
    return add_device_flag(p)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from csm_torch.watermarking import check_audio_from_file

    return 0 if check_audio_from_file(args.audio_path, args.watermark_ckpt, args.device) else 1


if __name__ == "__main__":
    sys.exit(main())
