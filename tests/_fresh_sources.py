"""A source factory for the app tests of both packages: a new QueueSource
for each stream the audio manager opens, push() feeding the newest one.

The port's AudioRecordingManager closes a stream's source with the stream
(a QueueSource's close ends it), so one QueueSource no longer serves
several streams; the JAX manager leaves its sources open, and the same
factory serves it unchanged."""


class FreshSources:
    def __init__(self, queue_source, sample_rate: int = 16000):
        self._cls, self._rate = queue_source, sample_rate
        self.made = []

    def __call__(self):
        self.made.append(self._cls(self._rate))
        return self.made[-1]

    def push(self, chunk) -> None:
        self.made[-1].push(chunk)
