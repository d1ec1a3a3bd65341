"""The OS shell's modules that the command surface reaches (port of
spittle_tpu/shell): the Apple Intelligence shim probe, feedback-sound
synthesis and playback, and audio device listing. The rest of
spittle_tpu/shell (microphone, hotkeys, typing, overlays, tray) is not
ported yet."""
