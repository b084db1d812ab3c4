"""Ports of the reference's amp examples (``examples/amp_functional/
main.py`` and ``examples/dcgan/main_amp.py``), each with a ``main`` that
runs on the card unless the caller passes ``device="cpu"``."""
