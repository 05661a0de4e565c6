"""Size limits of the wire that both its ends share (a module of
constants only, so that the server, the client and lifecycle/ import it
without importing one another)."""

# the header form of a generation checkpoint grows with prompt + generated
# (~8 base64 bytes a token); a server accepts a request head up to this
# much, and a client drops a larger checkpoint from its retry (restarting
# beats a 400)
CHECKPOINT_HEADER_MAX_BYTES = 1 << 20
# the header-field limit of every hop that carries the checkpoint header
CHECKPOINT_FIELD_SIZE_LIMIT = CHECKPOINT_HEADER_MAX_BYTES + 8190
# a request or response head: one checkpoint header field and 64 KiB for
# the rest
MAX_HEAD_BYTES = CHECKPOINT_FIELD_SIZE_LIMIT + (1 << 16)
