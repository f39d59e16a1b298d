# -*- coding: utf-8 -*-
"""
Render the documentation set to a static HTML site.

The reference project ships a Sphinx/readthedocs site built from
``docs/*.rst`` plus autodoc API pages (reference docs/conf.py,
docs/sourcecode.rst, docs/submodules/*.rst). This environment has no
sphinx, so this script is a dependency-light equivalent: it renders
every markdown page under ``docs/`` with python-markdown (baked in) and
generates an autodoc-style API reference by introspecting the installed
``quakemigrate_tpu`` package — module docstrings, public classes with
their method signatures/docstrings, and public functions — mirroring
the reference's submodule page set.

Output: ``docs/_build/html`` (self-contained, no JS, one CSS file).

Run: PYTHONPATH=/root/repo python tools/build_docs.py
Tests: tests/test_build_docs.py builds the site and checks pages,
internal links and API coverage.
"""

import html
import importlib
import inspect
import pathlib
import pkgutil
import re
import shutil
import sys

import markdown

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:  # standalone `python tools/build_docs.py`
    sys.path.insert(0, str(ROOT))
DOCS = ROOT / "docs"
OUT = DOCS / "_build" / "html"

# Mirrors reference docs/sourcecode.rst toctree (plus the packages this
# tree adds: seis, coords, parallel, ops — native stacks the reference
# outsources to ObsPy/pyproj/NumPy C loops).
API_PACKAGES = [
    "quakemigrate_tpu.core",
    "quakemigrate_tpu.ops",
    "quakemigrate_tpu.parallel",
    "quakemigrate_tpu.lut",
    "quakemigrate_tpu.io",
    "quakemigrate_tpu.seis",
    "quakemigrate_tpu.coords",
    "quakemigrate_tpu.signal",
    "quakemigrate_tpu.signal.onsets",
    "quakemigrate_tpu.signal.pickers",
    "quakemigrate_tpu.signal.local_mag",
    "quakemigrate_tpu.plot",
    "quakemigrate_tpu.export",
    "quakemigrate_tpu.util",
]

CSS = """
:root { --fg: #1a1a1a; --bg: #ffffff; --accent: #0b5394; --rail: #f4f6f8;
        --mono: ui-monospace, SFMono-Regular, Menlo, Consolas, monospace; }
* { box-sizing: border-box; }
body { margin: 0; color: var(--fg); background: var(--bg);
       font: 16px/1.55 -apple-system, "Segoe UI", Roboto, Helvetica, Arial,
       sans-serif; }
a { color: var(--accent); text-decoration: none; }
a:hover { text-decoration: underline; }
.layout { display: flex; min-height: 100vh; }
nav.side { width: 260px; flex: none; background: var(--rail);
           padding: 1.2rem 1rem; border-right: 1px solid #e2e6ea;
           font-size: 0.92rem; }
nav.side h1 { font-size: 1.02rem; margin: 0 0 0.8rem; }
nav.side ul { list-style: none; padding-left: 0.8rem; margin: 0.2rem 0; }
nav.side > ul { padding-left: 0; }
nav.side li { margin: 0.18rem 0; }
nav.side .sect { margin-top: 0.9rem; font-weight: 600; color: #444; }
main { flex: 1; min-width: 0; padding: 2rem 3rem; max-width: 60rem; }
main h1, main h2, main h3 { line-height: 1.25; }
main h1 { margin-top: 0.2rem; }
main h2 { border-bottom: 1px solid #e6e6e6; padding-bottom: 0.25rem;
          margin-top: 2rem; }
pre { background: #f6f8fa; padding: 0.8rem 1rem; overflow-x: auto;
      border-radius: 6px; font-size: 0.88rem; }
code { font-family: var(--mono); font-size: 0.92em; background: #f2f4f6;
       padding: 0.08em 0.3em; border-radius: 4px; }
pre code { background: none; padding: 0; }
table { border-collapse: collapse; margin: 1rem 0; font-size: 0.92rem; }
th, td { border: 1px solid #d8dde2; padding: 0.35rem 0.7rem;
         text-align: left; }
th { background: var(--rail); }
.api-entry { margin: 1.6rem 0; }
.api-sig { background: #eef3f8; border-left: 3px solid var(--accent);
           padding: 0.5rem 0.8rem; font-family: var(--mono);
           font-size: 0.88rem; white-space: pre-wrap; border-radius: 0 6px
           6px 0; }
.api-doc { margin: 0.5rem 0 0 1rem; }
.api-doc pre { margin: 0.4rem 0; }
.kind { color: #777; font-size: 0.78rem; text-transform: uppercase;
        letter-spacing: 0.06em; }
footer { margin-top: 3rem; color: #888; font-size: 0.85rem;
         border-top: 1px solid #eee; padding-top: 0.8rem; }
"""


def md_to_html(text):
    return markdown.markdown(
        text, extensions=["tables", "fenced_code", "toc"]
    )


def rewrite_links(html_text, depth):
    """Point intra-docs .md links at the rendered .html files."""

    def fix(match):
        target = match.group(1)
        if target.startswith(("http://", "https://", "#", "mailto:")):
            return match.group(0)
        target = re.sub(r"\.md(#[^\"']*)?$", r".html\1", target)
        return 'href="%s"' % target

    return re.sub(r'href="([^"]+)"', fix, html_text)


def page(title, body, depth=0):
    rel = "../" * depth
    nav = build_nav(rel)
    return (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        "<meta name='viewport' content='width=device-width, initial-scale=1'>"
        "<title>%s — quakemigrate_tpu</title>"
        "<link rel='stylesheet' href='%sstyle.css'></head><body>"
        "<div class='layout'>%s<main>%s"
        "<footer>quakemigrate_tpu — waveform migration on GPUs."
        " Static site built by tools/build_docs.py.</footer>"
        "</main></div></body></html>"
    ) % (html.escape(title), rel, nav, body)


NAV_PAGES = [
    ("Start here", None),
    ("Overview", "index.html"),
    ("Tutorial", "tutorial.html"),
    ("Migrating from QuakeMigrate", "migrating_from_quakemigrate.html"),
    ("Per-stage tutorials", None),
    ("Lookup tables", "tutorials/lut.html"),
    ("Waveform archives", "tutorials/archive.html"),
    ("Detect", "tutorials/detect.html"),
    ("Trigger", "tutorials/trigger.html"),
    ("Locate", "tutorials/locate.html"),
    ("Synthetic example", "tutorials/synthetic.html"),
    ("Reference", None),
    ("Architecture", "architecture.html"),
    ("Parameters", "parameters.html"),
    ("File formats", "file_formats.html"),
    ("Component inventory", "component_inventory.html"),
    ("Performance", "performance.html"),
    ("API reference", "api/index.html"),
]


def build_nav(rel):
    items = ["<nav class='side'><h1><a href='%sindex.html'>quakemigrate_tpu"
             "</a></h1><ul>" % rel]
    for label, target in NAV_PAGES:
        if target is None:
            items.append("<li class='sect'>%s</li>" % html.escape(label))
        else:
            items.append(
                "<li><a href='%s%s'>%s</a></li>"
                % (rel, target, html.escape(label))
            )
    items.append("</ul></nav>")
    return "".join(items)


def render_markdown_pages():
    count = 0
    for src in sorted(DOCS.rglob("*.md")):
        if "_build" in src.parts:
            continue
        rel = src.relative_to(DOCS).with_suffix(".html")
        depth = len(rel.parts) - 1
        body = rewrite_links(md_to_html(src.read_text()), depth)
        title = next(
            (
                line.lstrip("# ").strip()
                for line in src.read_text().splitlines()
                if line.startswith("#")
            ),
            rel.stem,
        )
        dst = OUT / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(page(title, body, depth))
        count += 1
    return count


def public_members(mod):
    """Public classes/functions defined in (or re-exported by) `mod`."""
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for name in names:
        obj = getattr(mod, name, None)
        if obj is None or inspect.ismodule(obj):
            continue
        if not (inspect.isclass(obj) or inspect.isfunction(obj)):
            continue
        owner = getattr(obj, "__module__", "") or ""
        if not owner.startswith("quakemigrate_tpu"):
            continue
        out.append((name, obj))
    return out


def fmt_signature(obj):
    try:
        return str(inspect.signature(obj))
    except (TypeError, ValueError):
        return "(...)"


def doc_html(obj):
    doc = inspect.getdoc(obj)
    if not doc:
        return "<p class='api-doc'><em>No docstring.</em></p>"
    # Docstrings are numpydoc-ish plain text: preserve layout.
    return "<div class='api-doc'><pre>%s</pre></div>" % html.escape(doc)


def render_class(name, cls):
    parts = [
        "<div class='api-entry' id='%s'>" % html.escape(name),
        "<div class='kind'>class</div>",
        "<div class='api-sig'>class %s%s</div>"
        % (html.escape(name), html.escape(fmt_signature(cls))),
        doc_html(cls),
    ]
    for mname, meth in sorted(vars(cls).items()):
        if mname.startswith("_") and mname != "__init__":
            continue
        func = meth.__func__ if isinstance(meth, (classmethod, staticmethod)) else meth
        if isinstance(meth, property):
            parts.append(
                "<div class='api-entry'><div class='kind'>property</div>"
                "<div class='api-sig'>%s.%s</div>%s</div>"
                % (html.escape(name), html.escape(mname), doc_html(meth))
            )
            continue
        if not inspect.isfunction(func):
            continue
        parts.append(
            "<div class='api-entry'><div class='kind'>method</div>"
            "<div class='api-sig'>%s.%s%s</div>%s</div>"
            % (
                html.escape(name),
                html.escape(mname),
                html.escape(fmt_signature(func)),
                doc_html(func),
            )
        )
    parts.append("</div>")
    return "".join(parts)


def render_function(name, func):
    return (
        "<div class='api-entry' id='%s'><div class='kind'>function</div>"
        "<div class='api-sig'>%s%s</div>%s</div>"
        % (
            html.escape(name),
            html.escape(name),
            html.escape(fmt_signature(func)),
            doc_html(func),
        )
    )


def render_api():
    (OUT / "api").mkdir(parents=True, exist_ok=True)
    index_rows = []
    pages = 0
    for pkg_name in API_PACKAGES:
        mod = importlib.import_module(pkg_name)
        members = public_members(mod)
        # Also sweep child modules not re-exported at package level.
        extra = []
        if hasattr(mod, "__path__"):
            for info in pkgutil.iter_modules(mod.__path__):
                if info.name.startswith("_") or info.ispkg:
                    continue
                child_name = "%s.%s" % (pkg_name, info.name)
                if child_name in API_PACKAGES:
                    continue
                try:
                    child = importlib.import_module(child_name)
                except Exception as exc:  # import-gated optional deps
                    extra.append((child_name, None, str(exc)))
                    continue
                seen = {n for n, _ in members}
                child_members = [
                    (n, o) for n, o in public_members(child) if n not in seen
                ]
                if child_members:
                    extra.append((child_name, child_members, None))

        body = ["<h1><code>%s</code></h1>" % html.escape(pkg_name)]
        mod_doc = inspect.getdoc(mod)
        if mod_doc:
            body.append("<pre>%s</pre>" % html.escape(mod_doc))
        for name, obj in members:
            body.append(
                render_class(name, obj)
                if inspect.isclass(obj)
                else render_function(name, obj)
            )
        for child_name, child_members, err in extra:
            body.append("<h2><code>%s</code></h2>" % html.escape(child_name))
            if err is not None:
                body.append(
                    "<p><em>Not importable in this environment: %s</em></p>"
                    % html.escape(err)
                )
                continue
            for name, obj in child_members:
                body.append(
                    render_class(name, obj)
                    if inspect.isclass(obj)
                    else render_function(name, obj)
                )
        fname = pkg_name + ".html"
        (OUT / "api" / fname).write_text(
            page(pkg_name, "".join(body), depth=1)
        )
        pages += 1
        index_rows.append(
            "<li><a href='%s'><code>%s</code></a> — %d public symbols</li>"
            % (html.escape(fname), html.escape(pkg_name), len(members))
        )

    top = importlib.import_module("quakemigrate_tpu")
    top_names = ", ".join(
        "<code>%s</code>" % html.escape(n)
        for n in sorted(getattr(top, "__all__", []) or sorted(
            n for n in vars(top) if not n.startswith("_")))
    )
    index_body = (
        "<h1>API reference</h1>"
        "<p>Generated from the package docstrings by tools/build_docs.py "
        "(the reference ships the equivalent Sphinx autodoc pages, "
        "reference docs/sourcecode.rst).</p>"
        "<p>Top-level exports: %s</p><ul>%s</ul>" % (top_names,
                                                     "".join(index_rows))
    )
    (OUT / "api" / "index.html").write_text(
        page("API reference", index_body, depth=1)
    )
    return pages + 1


def main():
    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    (OUT / "style.css").write_text(CSS)
    n_md = render_markdown_pages()
    n_api = render_api()
    print("built %d markdown pages + %d API pages -> %s" % (n_md, n_api, OUT))
    return 0


if __name__ == "__main__":
    sys.exit(main())
