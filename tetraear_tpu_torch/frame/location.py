"""Location extraction cascade: SDS text coordinates -> LIP binary -> MAC.

Behavioural equivalent of the reference LocationParser
(tetraear/core/location.py:13-223): regex parsing of decimal / DMS /
compact coordinate text, binary LIP reports, frame-level extraction
cascade, and map-URL helpers.
"""

from __future__ import annotations

import re

from tetraear_tpu_torch.frame import lip as lip_mod


class LocationParser:
    """All-static location parsing utilities (location.py:13)."""

    @staticmethod
    def parse_coordinates(text: str):
        """Lat/lon from text in decimal, DMS or compact form -> (lat, lon)
        or None (location.py:17-87)."""
        if not text:
            return None

        # Optional comma/semicolon between fields: the LIP formatter emits
        # "Lat: X, Lon: Y" which the reference's own regex cannot re-parse
        # (tetraear/core/location.py:28 vs protocol.py:1059).
        m = re.search(r"Lat:?\s*(-?\d+\.?\d*)[,;]?\s+Lon:?\s*(-?\d+\.?\d*)",
                      text, re.IGNORECASE)
        if m:
            try:
                lat, lon = float(m.group(1)), float(m.group(2))
                if -90 <= lat <= 90 and -180 <= lon <= 180:
                    return (lat, lon)
            except ValueError:
                pass

        m = re.search(
            r"(\d+)°(\d+)['′](\d+(?:\.\d+)?)[\"″]([NS])\s+"
            r"(\d+)°(\d+)['′](\d+(?:\.\d+)?)[\"″]([EW])", text)
        if m:
            try:
                lat = (int(m.group(1)) + int(m.group(2)) / 60
                       + float(m.group(3)) / 3600)
                if m.group(4) == "S":
                    lat = -lat
                lon = (int(m.group(5)) + int(m.group(6)) / 60
                       + float(m.group(7)) / 3600)
                if m.group(8) == "W":
                    lon = -lon
                if -90 <= lat <= 90 and -180 <= lon <= 180:
                    return (lat, lon)
            except ValueError:
                pass

        m = re.search(r"([NS])(\d+\.?\d*)\s+([EW])(\d+\.?\d*)", text)
        if m:
            try:
                lat = float(m.group(2))
                if m.group(1) == "S":
                    lat = -lat
                lon = float(m.group(4))
                if m.group(3) == "W":
                    lon = -lon
                if -90 <= lat <= 90 and -180 <= lon <= 180:
                    return (lat, lon)
            except ValueError:
                pass
        return None

    @staticmethod
    def format_coordinates(lat: float, lon: float) -> str:
        lat_dir = "N" if lat >= 0 else "S"
        lon_dir = "E" if lon >= 0 else "W"
        return f"{abs(lat):.4f}°{lat_dir}, {abs(lon):.4f}°{lon_dir}"

    @staticmethod
    def get_google_maps_url(lat: float, lon: float) -> str:
        return f"https://www.google.com/maps?q={lat},{lon}"

    @staticmethod
    def get_openstreetmap_url(lat: float, lon: float) -> str:
        return (f"https://www.openstreetmap.org/?mlat={lat}&mlon={lon}"
                f"&zoom=15")

    @staticmethod
    def parse_lip_message(data: bytes):
        """Byte-aligned LIP variant used by some networks: pdu-type octet +
        24-bit lat/lon words (location.py:113-176).  Distinct from the
        bit-packed ETSI layout in tetraear_tpu_torch.frame.lip."""
        if not data or len(data) < 10:
            return None
        try:
            pdu_type = data[0]
            if pdu_type == 0x00 and len(data) >= 10:
                lat = (int.from_bytes(data[1:4], "big", signed=True)
                       / (1 << 23)) * 180
                lon = (int.from_bytes(data[4:7], "big", signed=True)
                       / (1 << 23)) * 180
                if -90 <= lat <= 90 and -180 <= lon <= 180:
                    return {
                        "type": "LIP Short Report",
                        "latitude": lat,
                        "longitude": lon,
                        "formatted": LocationParser.format_coordinates(
                            lat, lon),
                    }
            elif pdu_type == 0x01 and len(data) >= 16:
                lat = (int.from_bytes(data[1:4], "big", signed=True)
                       / (1 << 23)) * 180
                lon = (int.from_bytes(data[4:7], "big", signed=True)
                       / (1 << 23)) * 180
                altitude = int.from_bytes(data[7:9], "big", signed=True)
                speed = int.from_bytes(data[9:11], "big")
                heading = int.from_bytes(data[11:13], "big")
                if -90 <= lat <= 90 and -180 <= lon <= 180:
                    return {
                        "type": "LIP Long Report",
                        "latitude": lat,
                        "longitude": lon,
                        "altitude": altitude,
                        "speed": speed / 10,
                        "heading": heading,
                        "formatted": LocationParser.format_coordinates(
                            lat, lon),
                    }
        except Exception:
            pass
        return None

    @staticmethod
    def extract_location_from_frame(frame: dict):
        """SDS-text -> LIP-hex -> MAC-PDU-binary cascade
        (location.py:178-223)."""
        sds_msg = frame.get("sds_message", "") or frame.get(
            "decoded_text", "") or ""

        if any(tag in sds_msg for tag in ("[LIP]", "[LOC]", "[GPS]")):
            coords = LocationParser.parse_coordinates(sds_msg)
            if coords:
                lat, lon = coords
                return {
                    "type": "GPS Text",
                    "latitude": lat,
                    "longitude": lon,
                    "formatted": LocationParser.format_coordinates(lat, lon),
                    "source": "SDS Message",
                }
            hex_data = sds_msg.split(":", 1)[-1].strip()
            try:
                data_bytes = bytes.fromhex(hex_data.replace(" ", ""))
                lip_data = LocationParser.parse_lip_message(data_bytes)
                if lip_data:
                    lip_data["source"] = "LIP Message"
                    return lip_data
            except ValueError:
                pass

        mac_pdu = frame.get("mac_pdu")
        if isinstance(mac_pdu, dict):
            data = mac_pdu.get("data")
            if isinstance(data, (bytes, bytearray)):
                lip_data = LocationParser.parse_lip_message(bytes(data))
                if lip_data:
                    lip_data["source"] = "MAC PDU"
                    return lip_data
                text = lip_mod.parse_lip(bytes(data))
                if text and text.startswith("Lat"):
                    coords = LocationParser.parse_coordinates(text)
                    if coords:
                        return {
                            "type": "LIP (bit-packed)",
                            "latitude": coords[0],
                            "longitude": coords[1],
                            "formatted": LocationParser.format_coordinates(
                                *coords),
                            "source": "MAC PDU",
                        }
        return None
