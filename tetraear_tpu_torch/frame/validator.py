"""Frame authenticity validation — is this real TETRA or noise?

Behavioural equivalent of the reference validator
(tetraear/core/validator.py:11-182): multiplicative confidence scoring over
CRC, frame structure, MCC/MNC plausibility, encryption sanity and decrypt
confidence, plus network tracking over one listening run.
"""

from __future__ import annotations

VALID_MCC_MIN = 200
VALID_MCC_MAX = 799

EUROPEAN_TETRA_MCCS = {
    202, 204, 206, 208, 212, 213, 214, 216, 218, 219, 220, 222, 225, 226,
    228, 230, 231, 232, 234, 235, 238, 240, 242, 244, 246, 247, 248, 250,
    255, 257, 259, 260, 262, 266, 268, 270, 272, 274, 276, 278, 280, 282,
    283, 284, 286, 288, 290, 292, 293, 294, 295, 297,
}

POLAND_MNC = {
    1: "Plus/Polkomtel",
    2: "T-Mobile Poland",
    3: "Orange Poland",
    6: "Play",
    98: "Mission Critical",
    99: "Emergency Services",
}


class TetraSignalValidator:
    """Scores decoded frames for authenticity (validator.py:11)."""

    VALID_MCC_MIN = VALID_MCC_MIN
    VALID_MCC_MAX = VALID_MCC_MAX
    EUROPEAN_TETRA_MCCS = EUROPEAN_TETRA_MCCS
    POLAND_MNC = POLAND_MNC

    def __init__(self, expected_country_mcc: int | None = None):
        self.expected_mcc = expected_country_mcc
        self.detected_networks: set = set()
        self.frame_count = 0
        self.valid_frame_count = 0

    def validate_mcc_mnc(self, mcc, mnc):
        """-> (is_valid, confidence, reason) (validator.py:49-88)."""
        if mcc is None:
            return (False, 0.0, "No MCC present")
        if mcc < VALID_MCC_MIN or mcc > VALID_MCC_MAX:
            return (False, 0.0,
                    f"MCC {mcc} out of valid range "
                    f"({VALID_MCC_MIN}-{VALID_MCC_MAX})")
        confidence = 0.5
        if mcc in EUROPEAN_TETRA_MCCS:
            confidence = 0.8
        if self.expected_mcc and mcc == self.expected_mcc:
            confidence = 0.95
            reason = f"MCC {mcc} matches expected location"
        elif self.expected_mcc and mcc != self.expected_mcc:
            confidence = 0.6
            reason = f"MCC {mcc} differs from expected {self.expected_mcc}"
        else:
            reason = f"MCC {mcc} is valid"
        if mnc is not None and mnc > 999:
            confidence *= 0.5
            reason += f" but MNC {mnc} seems high"
        self.detected_networks.add((mcc, mnc))
        return (True, confidence, reason)

    def validate_frame(self, frame: dict):
        """-> (is_valid, confidence, issues) (validator.py:90-161)."""
        self.frame_count += 1
        issues = []
        confidence = 1.0

        if "crc_ok" in frame and not frame["crc_ok"]:
            confidence *= 0.3
            issues.append("CRC failed")

        if frame.get("type_name") is None:
            confidence *= 0.5
            issues.append("No frame type")

        mcc = mnc = None
        if "call_metadata" in frame:
            mcc = frame["call_metadata"].get("mcc")
            mnc = frame["call_metadata"].get("mnc")
        elif "additional_info" in frame:
            mcc = frame["additional_info"].get("mcc")
            mnc = frame["additional_info"].get("mnc")

        if mcc is not None:
            valid, mcc_conf, reason = self.validate_mcc_mnc(mcc, mnc)
            if not valid:
                confidence = 0.0
                issues.append(reason)
            else:
                confidence *= mcc_conf
                if mcc_conf < 0.7:
                    issues.append(reason)
        else:
            if len(self.detected_networks) == 0:
                confidence *= 0.4
                issues.append("No network ID and no valid network seen yet")

        if frame.get("encrypted"):
            alg = frame.get("encryption_algorithm")
            if alg not in ("TEA1", "TEA2", "TEA3", "TEA4"):
                confidence *= 0.7
                issues.append(f"Unknown encryption: {alg}")

        if frame.get("decrypted") and frame.get("decrypt_confidence"):
            if frame["decrypt_confidence"] < 180:
                confidence *= 0.6
                issues.append(
                    f"Low decrypt confidence: {frame['decrypt_confidence']}")

        is_valid = confidence >= 0.5 and len(issues) <= 2
        if is_valid:
            self.valid_frame_count += 1
        return (is_valid, confidence, issues)

    def get_statistics(self) -> dict:
        valid_rate = self.valid_frame_count / max(1, self.frame_count)
        return {
            "total_frames": self.frame_count,
            "valid_frames": self.valid_frame_count,
            "valid_rate": valid_rate * 100,
            "detected_networks": list(self.detected_networks),
            "is_likely_tetra": valid_rate > 0.3,
        }

    def format_network_info(self, mcc, mnc) -> str:
        if mcc == 260:
            operator = POLAND_MNC.get(mnc, f"Unknown (MNC {mnc})")
            return f"\U0001F1F5\U0001F1F1 Poland MCC 260 - {operator}"
        return f"MCC {mcc} MNC {mnc}"
