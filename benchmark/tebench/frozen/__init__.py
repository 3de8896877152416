"""The reference's frozen copies of what it shares with the program: the
frame parsers (``crc``, ``burst``, ``lip``, ``sds``, ``mac`` from
tetraear_tpu_torch/frame), TEA (``tea``, from crypto/tea.py), the ETSI
channel-coding tables (``etsi_tables``, from voice/etsi_tables.py) and
the ETSI speech decoder (``csrc``, from voice/csrc), as they stood when
the benchmark was written.  They import nothing of the program and
change only with the benchmark."""
