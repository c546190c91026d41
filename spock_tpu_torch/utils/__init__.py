"""Utilities: reference-layout flat vectors (:mod:`.refvec`), checkpoints of
solver state (:mod:`.checkpoint`) and profiling helpers (:mod:`.profiling`)."""
