"""Runnable examples of the port's main entry points.

Each module makes its own input (the port's golden transmitter) or reads
the checked-in fixture, runs on the CUDA card unless it is given
``--device cpu``, and does nothing when it is imported::

    python -m tetraear_tpu_torch.examples.decode_capture [--device cpu]

See README.md beside this file for the list.
"""
