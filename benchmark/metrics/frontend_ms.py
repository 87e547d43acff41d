"""frontend_ms: host ms a window frame spends in the front end: grey
conversion (ops/pyramid.py:preprocess_image), the batched ORB extraction
of the pair (features/factory.py extract_batch over features/atlas.py and
ops/{pyramid,fast,orb}.py) and stereo matching
(ops/stereo.py:match_stereo_refined), from the traced run's wrappers."""


def read(run):
    spans = run.spans.get("frontend")
    return 1e3 * sum(spans) / run.frames if spans and run.frames else None
