"""Host-side cryptographic primitives of the reference-compatible PRF
(numpy and pure Python, no framework)."""
