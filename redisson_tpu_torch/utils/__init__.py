"""Host-side helpers: batched hashing and key encoding."""
