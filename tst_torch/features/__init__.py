"""The RF auditor's features and forest (counterpart of tst.features)."""
