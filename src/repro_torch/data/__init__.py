"""Sparse matrix generators (:mod:`.spdata`)."""
