"""Version info for paddle_tpu_torch (the reference's
``paddle_tpu/version.py``)."""

__version__ = "0.2.0"
