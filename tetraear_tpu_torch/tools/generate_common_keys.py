"""Generate ~200 common/weak TETRA keys in ALG:ID:HEX format.

Equivalent of the reference's generate_common_keys.py: null keys, repeating
bytes, sequential/reverse patterns, low-Hamming-weight keys, hex-word
patterns and MCC/MNC-derived keys some networks use.
"""

from __future__ import annotations

import argparse
import sys


def generate() -> list:
    keys = []
    # canonical test keys
    base_pairs = [
        ("00000000000000000000", "00000000000000000000000000000000"),
        ("11111111111111111111", "11111111111111111111111111111111"),
        ("FFFFFFFFFFFFFFFFFFFF", "FFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFF"),
        ("AAAAAAAAAAAAAAAAAAAA", "AAAAAAAAAAAAAAAAAAAAAAAAAAAAAAAA"),
        ("12345678901234567890", "12345678901234567890123456789012"),
        ("0123456789ABCDEF0123", "0123456789ABCDEF0123456789ABCDEF"),
        ("FEDCBA9876543210FEDC", "FEDCBA9876543210FEDCBA9876543210"),
    ]
    for k1, k2 in base_pairs:
        keys.append(f"TEA1:0:{k1}")
        for alg in ("TEA2", "TEA3", "TEA4"):
            keys.append(f"{alg}:0:{k2}")

    # small integers
    for i in range(10):
        keys.append(f"TEA1:0:{i:020X}")
        keys.append(f"TEA2:0:{i:032X}")
        keys.append(f"TEA3:0:{i:032X}")

    # repeating bytes
    for b in range(0, 256, 17):          # 00, 11, 22 ... FF
        bb = f"{b:02X}"
        keys.append(f"TEA1:0:{bb * 10}")
        keys.append(f"TEA2:0:{bb * 16}")

    # low Hamming weight
    for i in (0x1, 0x3, 0x7, 0xF, 0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF):
        keys.append(f"TEA1:0:{i:020X}")
        keys.append(f"TEA2:0:{i:032X}")

    # hex-word patterns
    for word in ("DEADBEEF", "CAFEBABE", "BAADF00D", "FEEDFACE",
                 "C0FFEE00"):
        keys.append(f"TEA1:0:{(word * 3)[:20]}")
        keys.append(f"TEA2:0:{(word * 5)[:32]}")
        keys.append(f"TEA3:0:{(word * 5)[:32]}")

    # MCC/MNC-derived (some networks key on network identity)
    for mcc in ("262", "222", "240", "228", "214", "260"):
        for mnc in range(10):
            base = f"{mcc}{mnc:02d}"
            keys.append(f"TEA1:0:{base}{'0' * 15}")
            keys.append(f"TEA2:0:{base}{'0' * 27}")

    # dedup preserving order
    seen = set()
    out = []
    for k in keys:
        if k not in seen:
            seen.add(k)
            out.append(k)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="generate-keys")
    ap.add_argument("-o", "--output", help="write to file instead of stdout")
    args = ap.parse_args(argv)
    keys = generate()
    lines = [f"# Generated {len(keys)} common TETRA encryption keys",
             "# Format: ALG:KEY_ID:HEX — load with --keys / set_keys()",
             ""] + keys
    text = "\n".join(lines) + "\n"
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"wrote {len(keys)} keys to {args.output}", file=sys.stderr)
    else:
        print(text, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
