"""Frozen copy of the FT8 protocol tables, packer and unpacker of the
PyTorch port (rtlsdr_ft8d_tpu_torch/protocol/), numpy only."""
