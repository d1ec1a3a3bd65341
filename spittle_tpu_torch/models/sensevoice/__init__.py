"""SenseVoice-Small (SAN-M encoder + CTC) in PyTorch."""
