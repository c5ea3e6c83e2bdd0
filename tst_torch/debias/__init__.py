"""Iterative Bias Pruning (counterpart of tst.debias)."""
