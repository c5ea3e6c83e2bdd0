"""Data helpers of the port that cannot be shared with tst (counterpart of tst.data)."""
