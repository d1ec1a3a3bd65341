"""The app's managers (port of spittle_tpu/managers)."""
