"""Audio frontend: mu-law wire decode, log-mel, resampling, WAV files and
the Silero VAD chain (audio/vad)."""
