"""Audio frontend: mu-law wire decode and log-mel."""
