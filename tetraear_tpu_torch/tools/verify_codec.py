"""Standalone functional test of the voice codec library.

Equivalent of the reference's tools/verify_codec.py (which exercised the
four ETSI .exes with synthetic 690-short frames): checks library presence,
block-size/header validation, channel-decoder output layout
((1+137) int16 x 2 frames) and the channel->speech chain.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="verify-codec")
    ap.add_argument("--build", action="store_true",
                    help="build the C++ codec library first")
    args = ap.parse_args(argv)

    if args.build:
        # the port's own voice/csrc, built by native.py into its build/
        from tetraear_tpu_torch import native
        try:
            native.codec()
        except RuntimeError as e:
            print(f"[!] build failed: {e}")
            return 1

    from tetraear_tpu_torch.voice import codec

    vp = codec.VoiceProcessor()
    print(f"[*] codec library loaded: {vp.working}")
    if not vp.working:
        print("[!] build it with: verify-codec --build")
        return 1

    # synthetic frame: header + strong soft bits
    rng = np.random.default_rng(0)
    block = np.zeros(codec.CODEC_BLOCK_WORDS, dtype=np.int16)
    block[0] = codec.CODEC_HEADER
    block[1:436] = rng.choice(np.array([-127, 127], np.int16), 435)
    frame = block.tobytes()

    out = vp.channel_decode(frame)
    assert out is not None, "channel decode returned None"
    assert out.shape == (2, 1 + codec.SPEECH_FRAME_PARAMS), out.shape
    print(f"[*] channel decode OK: shape {out.shape}, "
          f"BFI frame1={out[0, 0]} frame2={out[1, 0]}")

    audio = vp.decode_frame(frame)
    print(f"[*] full decode: {len(audio)} PCM samples "
          f"(max amp {np.max(np.abs(audio)) if len(audio) else 0:.4f})")

    # invalid inputs must degrade gracefully
    assert len(vp.decode_frame(b"")) == 0
    assert len(vp.decode_frame(b"\x00" * 100)) == 0
    bad = bytearray(frame)
    bad[0] = 0  # break header
    assert len(vp.decode_frame(bytes(bad))) == 0
    print("[*] validation paths OK")

    # round trip through the channel coder when available
    try:
        coded = np.zeros(codec.CODEC_BLOCK_WORDS, np.int16)
        import ctypes
        rc = vp._lib.tetra_channel_encode(
            np.ascontiguousarray(out).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int16)),
            coded.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)))
        if rc == 0:
            assert coded[0] == codec.CODEC_HEADER
            redec = vp.channel_decode(coded.tobytes())
            match = np.mean(redec[:, 1:] == out[:, 1:])
            print(f"[*] encode->decode round trip: {match:.3f} "
                  f"parameter agreement")
    except Exception as e:
        print(f"[!] round-trip check skipped: {e}")
    print("[+] codec verification complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
