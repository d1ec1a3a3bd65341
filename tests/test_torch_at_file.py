"""@file expansion in the port (spittle_tpu_torch/text/at_file.py and
app/context_providers.py) against the JAX package's on the CPU, over the
cases of tests/test_at_file.py: parse_at_tokens on each text,
resolve_token on each token and expand_at_refs on each text over one
temporary Git workspace, snippets, the workspace walk, the Git gate, and
the workspace-root resolution with its MRU."""

import os

import pytest

from spittle_tpu.app import context_providers as j_ctx
from spittle_tpu.config.settings import AppSettings as JAppSettings
from spittle_tpu.text import at_file as j_at
from spittle_tpu_torch.app import context_providers as t_ctx
from spittle_tpu_torch.config.settings import AppSettings as TAppSettings
from spittle_tpu_torch.text import at_file as t_at

TEXTS = [
    "check @main.rs for bugs", 'open @"my file.ts" please',
    "mail me at user@example.com thanks", "diff @a.rs and @b.rs",
    "see @src/lib/mod.rs here", "look at @main.rs.",
    "include file auth dot ts in the prompt", "reference src slash lib dot rs",
    "this is for everyone", "fix this for main dot rs", "@auth.ts is important",
    "see @auth.ts", "open @auth.ts, then continue", "@auth.ts and @auth.ts again",
    "Check @auth-config.ts and @utils_helpers.ts", 'Look at @"my auth file.ts"',
    'Open @"src/my utils/helper.ts" now', "hello@world.com", "a@b", "@", "@ ", '@""',
    "please at file auth dot ts", "include file config dot json here",
    "at file widget dot tsx", "at file trade. r s now", "Fix @main.rs, then commit.",
    "include file main dot rs please", "see @real.ts and @missing.xyz",
    "See @first.ts then @second.ts", "check @missing.go now", "nothing here", "",
    "reference file auth handler dot ts", "open @dup.txt", "@cargo.tomal",
    "@transcripton.rs", "@managrs/audio.rs", "@src/man.rs", "@dockerfile",
]

TOKENS = [
    "main.rs", "src/main.rs", "nonexistent.go", "dup.txt", "auth handler.ts",
    "src/man.rs", "Auth.ts", "auth.ts", "auth helpers.ts", "dockerfile",
    "cargo.tomal", "transcripton.rs", "managrs/audio.rs", "src/auth.ts",
    "my file.ts", "real.ts", "auth2.ts", "widget.tsx", "helpers.rs",
]

FILES = {
    "src/main.rs": "fn main() {}", "src/auth_handler.ts": "x", "README.md": "hi",
    "dup.txt": "a", "src/dup.txt": "b", "my file.ts": "x", "Auth.ts": "test",
    "auth2.ts": "close", "authHelpers.ts": "x", "auth_helpers.rs": "x",
    "dockerfile": "FROM scratch", "cargo.toml": 'name = "demo"',
    "transcription.rs": "x", "managers/audio.rs": "x", "src/auth.ts": "deep",
    "real.ts": "content", "first.ts": "first content", "second.ts": "second content",
    "widget.tsx": "<div/>", "a.rs": "a", "b.rs": "b", "src/lib/mod.rs": "mod",
    "src/lib.rs": "lib", "config.json": "{}", "trade.rs": "t",
    "src/my utils/helper.ts": "h", "node_modules/junk.js": "x",
    "big.py": "\n".join(f"line{i}" for i in range(500)),
    "wide.txt": "x" * 30_000 + "\nEND\n",
    "unicode.rs": "// Unicode: 你好世界 \U0001F680 Ñoño\nfn main() {}",
}


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    root = tmp_path_factory.mktemp("ws")
    (root / ".git").mkdir()
    for rel, text in FILES.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text, encoding="utf-8")
    (root / "bin.dat").write_bytes(b"abc\0def")
    deep = root
    for i in range(12):
        deep = deep / f"level{i}"
    deep.mkdir(parents=True)
    (deep / "deep.txt").write_text("deep")
    return str(root)


@pytest.fixture(autouse=True)
def clear_caches():
    for mod in (t_at, j_at):
        mod._index_cache.clear()
    yield
    for mod in (t_at, j_at):
        mod._index_cache.clear()


def _tokens(mod, text):
    return [(t.token, t.start, t.end) for t in mod.parse_at_tokens(text)]


@pytest.mark.parametrize("text", TEXTS)
def test_parse_and_expand(repo, text):
    assert _tokens(t_at, text) == _tokens(j_at, text)
    got = t_at.expand_at_refs(text, repo)
    assert got == j_at.expand_at_refs(text, repo)
    for enabled in (True, False):
        assert (t_at.maybe_expand_at_refs(text, enabled, repo)
                == j_at.maybe_expand_at_refs(text, enabled, repo))


def test_expansion_rewrites_resolved_tokens(repo):
    out = t_at.expand_at_refs("Fix @main.rs, then commit.", repo)
    assert out == "Fix @" + os.path.join(repo, "src", "main.rs") + ", then commit."
    assert t_at.expand_at_refs("check @missing.go now", repo) == "check @missing.go now"


@pytest.mark.parametrize("token", TOKENS)
def test_resolve_token(repo, token):
    entries = t_at.walk_workspace(repo)
    assert entries == j_at.walk_workspace(repo)
    assert (t_at.resolve_token(token, repo, entries)
            == j_at.resolve_token(token, repo, entries))


def test_walk_snippets_and_git_gate(repo, tmp_path):
    entries = t_at.walk_workspace(repo)
    assert not any("node_modules" in e or "deep.txt" in e for e in entries)
    for rel in ("big.py", "wide.txt", "unicode.rs", "bin.dat", "src/main.rs", "missing"):
        path = os.path.join(repo, rel)
        assert t_at.extract_snippet(path, repo) == j_at.extract_snippet(path, repo), rel
    sub = tmp_path / "a" / "b"
    sub.mkdir(parents=True)
    for start in (str(sub), repo, os.path.join(repo, "src")):
        assert t_at.is_git_repository(start) == j_at.is_git_repository(start)
    for a, b in (("abc", "acb"), ("ab", "ba"), ("kitten", "sitting"), ("", "x")):
        assert t_at.damerau_levenshtein(a, b) == j_at.damerau_levenshtein(a, b)
        assert t_at.levenshtein(a, b) == j_at.levenshtein(a, b)
    for s in ("myFileName", "my_file-name two", "HTTPServer"):
        assert t_at.normalize_to_words(s) == j_at.normalize_to_words(s)


@pytest.mark.parametrize("bundle", [None, "com.todesktop.cursor", "com.microsoft.vscode",
                                    "com.googlecode.iterm2", "org.mozilla.firefox"])
def test_workspace_root_resolution(repo, tmp_path, bundle):
    runs = []
    for ctx, settings_cls, home in ((t_ctx, TAppSettings, tmp_path / "port"),
                                    (j_ctx, JAppSettings, tmp_path / "jax")):
        home.mkdir()
        s = settings_cls()
        s.recent_workspace_roots = [str(tmp_path / "gone"), os.path.join(repo, "src")]
        before = ctx.get_workspace_root(s, lambda: bundle, home=str(home))
        ctx.write_cursor_context([repo], home=str(home))
        ctx.write_terminal_context(os.path.join(repo, "managers"), home=str(home))
        after = ctx.get_workspace_root(s, lambda: bundle, home=str(home))
        mru = ctx.update_mru(["a", "b", "c", "d", "e"], "c")
        runs.append((before, after, mru, ctx.update_mru(mru, "f"),
                     ctx.is_terminal_bundle_id(bundle or "")))
    assert runs[0] == runs[1]
