"""Artifact writers of the port (its copy of tst.io)."""
