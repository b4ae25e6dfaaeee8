"""StoryStream dataset construction and chunking tools; the port's own copy
of ``seed_story_tpu/tools/storystream.py``.

GPT-4(-V) pipelines build story-format jsonl from keyframes, and the
re-chunker splits 30-frame stories into 10-frame training samples
(StoryStream's chunk_data.py:24-45). The ``{{name->story@@...}}`` output
grammar parser (build_story_v2.py:167-192) keeps the reference's behavior.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, List, Optional

from ..eval.gpt_score_eval import api_call, default_client, encode_image


# ---------------------------------------------------------------------
# chunk_data.py
# ---------------------------------------------------------------------


def split_entries(entries: List[Dict], chunk_size: int = 10) -> List[Dict]:
    """30-frame stories -> chunk_size-frame samples, dropping ragged tails
    (reference chunk_data.py:4-22)."""
    out = []
    for idx, entry in enumerate(entries):
        images, captions = entry["images"], entry["captions"]
        if len(images) != len(captions):
            continue
        for i in range(0, len(images), chunk_size):
            ci, cc = images[i : i + chunk_size], captions[i : i + chunk_size]
            if len(ci) == chunk_size and len(cc) == chunk_size:
                out.append({"id": idx, "images": ci, "captions": cc})
    return out


def chunk_files(input_pattern: str, output_file: str, chunk_size: int = 10):
    entries = []
    for path in glob.glob(input_pattern):
        with open(path, encoding="utf-8") as f:
            entries.extend(json.loads(line) for line in f if line.strip())
    chunks = split_entries(entries, chunk_size)
    with open(output_file, "w", encoding="utf-8") as f:
        for e in chunks:
            f.write(json.dumps(e) + "\n")
    return len(chunks)


# ---------------------------------------------------------------------
# build_story.py (v1 — caption/subtitle text pipeline)
# ---------------------------------------------------------------------

# Verbatim v1 protocol string (reference build_story.py:18-27) — like the
# v2/STORY instructions below, the text IS the dataset-construction
# protocol, so it is kept word for word.
V1_PROMPT = """
Create a connected story from the captions of these 'Curious George' cartoon keyframes, following these guidelines:

1. Ensure each part of the story aligns with its corresponding image caption.
2. Include "George" in the narrative whenever the caption mentions a monkey.
3. The story should flow logically from one image to the next, using child-friendly language.
4. Format the output as: [filename.jpg]->[narrative], with each image and its story on a separate line.
5. Directly provide the requested output without including this instruction conversation.
6. The overall story should be cohesive and engaging.
"""

# v1 line grammar (reference build_story.py:66-71): non-greedy prefix up to
# the FIRST literal ".jpg->"; the path is group(1)+".jpg". Kept exactly —
# e.g. a bracketed "[file.jpg]->[story]" line does NOT match, same as the
# reference.
V1_LINE = re.compile(r"(.*?)\.jpg->(.*)")


def extract_v1_lines(gpt_output: str):
    """'filename.jpg->narrative' lines -> (image_paths, captions)
    (reference build_story.py:55-74)."""
    image_paths, captions = [], []
    for line in gpt_output.strip().split("\n"):
        m = V1_LINE.match(line.strip())
        if m:
            image_paths.append(m.group(1) + ".jpg")
            captions.append(m.group(2).strip())
    return image_paths, captions


def build_v1_story(description_lines: List[str], story_id: int,
                   subtitle: Optional[str] = None, client=None,
                   model: str = "gpt-4-1106-preview") -> Optional[Dict]:
    """One v1 GPT call over a batch of caption-jsonl lines -> story record.

    Mirrors reference build_story.py:125-156: the raw jsonl lines are joined
    with spaces and appended to the prompt ('Image Descriptions'); when a
    subtitle blob is given (the reference's ``with_subtitle`` variant,
    :16,133-134) it is appended after the descriptions; output is parsed with
    the v1 line grammar into {id, images, captions, orders}.
    """
    client = client or default_client()
    content = V1_PROMPT + "Image Descriptions: \n" + " ".join(description_lines)
    if subtitle is not None:
        content += "Subtitles: \n" + subtitle
    messages = [{"role": "user", "content": content}]
    res = api_call(client, messages, model=model, temperature=0.3)
    if not res:
        return None
    image_paths, captions = extract_v1_lines(res)
    return {
        "id": story_id,
        "images": image_paths,
        "captions": captions,
        "orders": list(range(len(image_paths))),
    }


def build_stories_v1(description_path: str, output_path: str, client=None,
                     story_len: int = 30,
                     subtitles: Optional[List[str]] = None,
                     model: str = "gpt-4-1106-preview") -> int:
    """Full v1 pipeline (reference build_story.py:94-122): batch the caption
    jsonl into ``story_len``-line groups (the ragged tail is also processed),
    one GPT call per group, append one story record per group.

    Deliberate deviation: records are written with ``json.dumps`` — the
    reference writes ``str(dict)`` (python repr, single quotes), which its
    own jsonl readers cannot parse back; valid JSON is what the published
    StoryStream files actually contain.
    """
    client = client or default_client()
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(description_path, encoding="utf-8") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    written = 0
    for start in range(0, len(lines), story_len):
        batch = lines[start : start + story_len]
        subtitle = subtitles[start // story_len] if subtitles else None
        record = build_v1_story(batch, story_id=written, subtitle=subtitle,
                                client=client, model=model)
        if record is None:
            continue
        with open(output_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")
        written += 1
    return written


# ---------------------------------------------------------------------
# build_story_v2.py
# ---------------------------------------------------------------------

STORY_GRAMMAR = re.compile(r"\{\{(.*?)\}\}", re.S)


def convert_to_jsonl(input_string: str) -> Optional[str]:
    """Parse the '{{img->caption@@img->caption...}}' grammar
    (reference build_story_v2.py:167-192)."""
    m = STORY_GRAMMAR.search(input_string)
    if not m:
        return None
    images, captions = [], []
    for entry in m.group(1).split("@@"):
        if "->" in entry:
            image, caption = entry.split("->", 1)
            images.append(image.strip())
            captions.append(caption.strip())
    return json.dumps({"images": images, "captions": captions})


def find_jpg_files(directory: str) -> List[str]:
    """Natural-sorted recursive jpg listing (reference :196-211)."""
    jpgs = []
    for root, _, files in os.walk(directory):
        jpgs += [os.path.join(root, f) for f in files if f.endswith(".jpg")]

    def natural(s):
        return sum(((t, int(n)) for t, n in re.findall(r"(\D+)(\d+)", "a%s0" % s)), ())

    return sorted(jpgs, key=lambda x: natural(x.split("/")[-1]))


# The GPT instruction strings ARE the dataset-construction protocol: the
# published StoryStream jsonl was produced by exactly this text (reference
# build_story_v2.py:16-49, incl. its literal backslash-escaped braces), so
# they are kept verbatim — like the GPT-judge protocols in eval/. Changing a
# word changes the dataset.
STORY_INSTRUCTION = (
    "You are a gifted storyteller specializing in creating engaging narratives "
    "for children based on visual cues and the previous story. Your task is to craft "
    "a charming story from a series of images from the cartoon \"Rabbits Invasion.\" "
    "\nImage Use: I will provide every image to you. File names are listed below. "
    "You should fully understand the semantics and details of these images and use "
    "them for the story. "
    "\nPrevious Story Use: I will provide you the previous story. If the previous "
    "story is empty, then you can start a new story on your own. When the previous "
    "story exists, make sure the new story is continuous. "
    "\nNarrative Requirements: Ensure that the narrative is child-friendly and "
    "coherent across all images. The language should be simple and understandable "
    "for children aged 5-8 years. "
    "\nOutput Format: Deliver the story in the following format, ensuring all parts "
    "are connected: "
    "\n    * \\{\\{[keyframe_file_name_0]->[story_0]@@keyframe_file_name_1->story_1@@"
    "keyframe_file_name_2->story_2@@…\\}\\} "
    "\n    * replace the [keyframe_file_name_x] with the real keyframe name. replace "
    "the [story_x] with your generated story. "
    "\nYour goal is to weave these individual images into a seamless and "
    "entertaining story that captures the imagination of young readers."
)

LINK_INSTRUCTION = (
    "You are a gifted storyteller specializing in creating engaging narratives for children. "
    "Your task is to link several charming stories from the cartoon \"Rabbits Invasion Into\" a long story. "
    "Story Use: I will provide several stories for you. You may modify the story text to make them more continuous. "
    "Narrative Requirements: Ensure that the narrative is child-friendly and coherent across all images. "
    "The language should be simple and understandable for children aged 5-8 years. "
    "Output Format: Deliver the story in the following format, ensuring all parts are connected: "
    "* \\{\\{[keyframe_file_name_0]->[story_0]@@keyframe_file_name_1->story_1@@keyframe_file_name_2->story_2@@…\\}\\} "
    "* replace the [keyframe_file_name_x] with the real keyframe name. replace "
    "the [story_x] with your generated story."
    "Your goal is to weave these individual stories into a seamless and "
    "entertaining long story that captures the imagination of young readers."
)


def construct_dataset(image_batch: List[str], pool,
                      client=None, model="gpt-4-turbo-2024-04-09",
                      instruction: str = STORY_INSTRUCTION) -> Optional[str]:
    """One GPT-4V call over a 10-image batch -> raw grammar string.

    Message structure mirrors the reference (build_story_v2.py:84-133):
    one user message per image, then the instruction, the file-name list,
    and the previous-story pool."""
    client = client or default_client()
    image_names = [os.path.basename(p) for p in image_batch]
    messages = [
        {"role": "user", "content": [{
            "type": "image_url",
            "image_url": {"url": "data:image/jpeg;base64," + encode_image(p)},
        }]}
        for p in image_batch
    ]
    for text in (instruction,
                 "File names: {}".format(image_names),
                 "Previous Story: {}".format(pool)):
        messages.append(
            {"role": "user", "content": [{"type": "text", "text": text}]}
        )
    return api_call(client, messages, model=model)


def link_dataset(pool, client=None, model="gpt-4-turbo-2024-04-09",
                 instruction: str = LINK_INSTRUCTION) -> Optional[str]:
    """Link 3 x 10-frame fragments into one 30-frame story (reference
    :138-164)."""
    client = client or default_client()
    messages = [
        {"role": "user", "content": [{"type": "text", "text": instruction}]},
        {"role": "user", "content": [{
            "type": "text", "text": "\nstories: {}".format(pool)
        }]},
    ]
    return api_call(client, messages, model=model)


def build_stories(image_dir: str, output_path: str, client=None,
                  batch: int = 10, pool_size: int = 3) -> int:
    """Full v2 pipeline (reference main(), :214-240)."""
    client = client or default_client()
    images = find_jpg_files(image_dir)
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    pool: List[str] = []
    written = 0
    for i in range(0, len(images), batch):
        story = construct_dataset(images[i : i + batch], pool, client=client)
        if story is None:
            continue
        pool.append(story)
        if len(pool) >= pool_size:
            linked = link_dataset(pool, client=client)
            if linked is not None:
                line = convert_to_jsonl(linked)
                if line is not None:
                    with open(output_path, "a+") as f:
                        f.write(line + "\n")
                    written += 1
            pool = []
    return written


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("chunk")
    c.add_argument("--input", required=True)
    c.add_argument("--output", required=True)
    c.add_argument("--chunk_size", type=int, default=10)
    b = sub.add_parser("build")
    b.add_argument("--image_dir", required=True)
    b.add_argument("--output", required=True)
    v1 = sub.add_parser("build_v1")
    v1.add_argument("--captions", required=True,
                    help="captions.jsonl (gpt4v descriptive lines)")
    v1.add_argument("--output", required=True)
    v1.add_argument("--story_len", type=int, default=30)
    a = p.parse_args()
    if a.cmd == "chunk":
        print(chunk_files(a.input, a.output, a.chunk_size), "chunks written")
    elif a.cmd == "build_v1":
        print(build_stories_v1(a.captions, a.output, story_len=a.story_len),
              "stories written")
    else:
        print(build_stories(a.image_dir, a.output), "stories written")
