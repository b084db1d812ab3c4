"""Test fixtures (counterpart of ``apex_tpu/transformer/testing/``)."""
