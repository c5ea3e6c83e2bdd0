# The port's own copy of tst/native/__init__.py (the port imports nothing of tst).
from tst_torch.native.fast_pack import native_available, pack_byte_batch  # noqa: F401
