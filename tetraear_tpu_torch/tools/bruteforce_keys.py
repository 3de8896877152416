"""Offline key bruteforce over recorded JSONL frames.

Equivalent of the reference's bruteforce_keys.py: load a key list + a
continuous-capture JSONL, try every key against every encrypted frame's
MAC payload, and rank decryptions by text plausibility.  The full
keys x frames product of both cipher families decrypts in ONE launch of
the ``tea_search`` kernel on the card (crypto.batch.tea_decrypt_families
— bit-exact vs the host TEA; ``--device cpu`` runs its plain version);
only the text scoring of the resulting plaintexts runs on host.
"""

from __future__ import annotations

import argparse
import json


def score_text(text: str) -> float:
    """Plausibility score (bruteforce_keys.py:40-63 semantics)."""
    if not text:
        return 0.0
    clean = text.strip()
    if len(clean) < 4:
        return 0.0
    printable = sum(1 for c in clean if c.isprintable())
    alpha = sum(1 for c in clean if c.isalpha())
    spaces = clean.count(" ")
    score = printable / len(clean) + alpha / len(clean)
    if spaces > 0:
        score += 0.2
    if any(c.isupper() for c in clean) and any(c.islower() for c in clean):
        score += 0.3
    return max(0.0, score)


def load_keys(path) -> list:
    keys = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(":")
            hex_key = parts[-1] if len(parts) >= 3 else line
            alg = parts[0].upper() if len(parts) >= 3 else None
            keys.append((alg, hex_key))
    return keys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bruteforce-keys")
    ap.add_argument("frames", help="continuous-capture JSONL file")
    ap.add_argument("-k", "--keys", required=True,
                    help="key list (ALG:ID:HEX or bare hex per line)")
    ap.add_argument("--max-frames", type=int, default=50)
    ap.add_argument("--min-score", type=float, default=1.2)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the kernel's plain version)")
    args = ap.parse_args(argv)

    from tetraear_tpu_torch.device import resolve
    resolve(args.device)

    from tetraear_tpu_torch.frame import sds

    keys = load_keys(args.keys)
    print(f"[*] loaded {len(keys)} keys")

    frames = []
    with open(args.frames, encoding="utf-8") as f:
        for line in f:
            try:
                fr = json.loads(line)
            except json.JSONDecodeError:
                continue
            data = (fr.get("mac_pdu") or {}).get("data")
            if fr.get("encrypted") and data:
                frames.append(fr)
    print(f"[*] {len(frames)} encrypted frames "
          f"(testing first {min(len(frames), args.max_frames)})")
    frames = frames[:args.max_frames]
    if not frames:
        print("[!] no encrypted frames to test")
        return 1

    payloads = []
    for fr in frames:
        try:
            pb = bytes.fromhex(fr["mac_pdu"]["data"])
        except (ValueError, TypeError):
            continue
        if len(pb) % 8:
            pb += b"\x00" * (8 - len(pb) % 8)
        if len(pb) >= 8:
            payloads.append(pb)

    # expand (alg, key) combos and group by cipher family; both
    # families' full keys x frames products are ONE device launch
    import numpy as np
    from tetraear_tpu_torch.crypto import batch

    combos = []                       # (alg_label, key_bytes, hex)
    for alg, hex_key in keys:
        try:
            kb = bytes.fromhex(hex_key)
        except ValueError:
            continue
        algs = [alg] if alg else (
            ["TEA1"] if len(kb) == 10 else ["TEA2", "TEA3"])
        for a in algs:
            want = 10 if a == "TEA1" else 16
            if len(kb) == want:
                combos.append((a, kb, hex_key))

    lmax = max(len(pb) for pb in payloads)
    payload_mat = np.zeros((len(payloads), lmax), np.uint8)
    for fi, pb in enumerate(payloads):
        payload_mat[fi, :len(pb)] = np.frombuffer(pb, np.uint8)

    fam_keys = {"TEA1": [], "TEA2": []}
    fam_index = {"TEA1": {}, "TEA2": {}}
    for a, kb, _ in combos:
        f = "TEA1" if a == "TEA1" else "TEA2"
        if kb not in fam_index[f]:
            fam_index[f][kb] = len(fam_keys[f])
            fam_keys[f].append(kb)
    for fam in ("TEA1", "TEA2"):
        if fam_keys[fam]:
            print(f"[*] device search: {len(fam_keys[fam])} {fam}-family "
                  f"keys x {len(payloads)} frames")
    plains = {}                       # family -> (key -> row of matrix)
    if combos:
        # (K1 + K2, B, L), TEA1's keys first
        mat = batch.tea_decrypt_families(payload_mat, fam_keys["TEA1"],
                                         fam_keys["TEA2"],
                                         device=args.device)
        k1 = len(fam_keys["TEA1"])
        plains = {"TEA1": (mat[:k1], fam_index["TEA1"]),
                  "TEA2": (mat[k1:], fam_index["TEA2"])}

    results = []
    for a, kb, hex_key in combos:
        fam = "TEA1" if a == "TEA1" else "TEA2"
        mat, index = plains[fam]
        ki = index[kb]
        for fi, pb in enumerate(payloads):
            plain = mat[ki, fi, :len(pb)].tobytes()
            text = sds.unpack_gsm7(plain[:40])
            s = score_text(text)
            try:
                ascii_text = plain.decode("ascii")
                s = max(s, score_text(ascii_text) + 0.2)
                text = ascii_text if score_text(ascii_text) > \
                    score_text(text) else text
            except UnicodeDecodeError:
                pass
            # SDS payloads carry a protocol-ID byte (e.g. 0x82) before
            # the text and zero padding after it: a printable-stripped
            # latin-1 view catches those
            lat = "".join(c for c in plain.decode("latin-1")
                          if c.isprintable())
            if len(lat) >= 4 and score_text(lat) + 0.2 > s:
                s = score_text(lat) + 0.2
                text = lat
            if s >= args.min_score:
                results.append({"key": f"{a}:{hex_key}", "frame": fi,
                                "text": text[:100], "score": s})
                print(f"[+] candidate score={s:.2f} key={a}:"
                      f"{hex_key[:20]}... text={text[:60]!r}")

    results.sort(key=lambda r: -r["score"])
    print(f"\n[*] complete: {len(results)} candidates")
    for i, r in enumerate(results[:args.top], 1):
        print(f"{i:2d}. {r['score']:.2f}  {r['key']}  {r['text']!r}")
    if not results:
        print("[-] no readable plaintext with these keys — the network "
              "likely uses strong unique keys")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
