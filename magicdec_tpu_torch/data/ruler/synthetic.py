"""RULER-style synthetic long-context task generators (counterpart of
magicdec_tpu/data/ruler/synthetic.py: the same rows, character for
character, for the same arguments and seed).

The task families of NVIDIA's RULER suite, each row a JSON object
{"index", "input", "outputs", "length"}:
  - niah: needle-in-a-haystack (single/multi key-value needles in filler text)
  - variable_tracking: chained variable assignments, query the final hop
  - common_words_extraction: find the words common to all lists
  - freq_words_extraction: find the most frequent words
  - qa: answer a question from a gold document among shuffled distractors
"""

from __future__ import annotations

import json
import random
import string
from typing import Dict, Iterator, List

_FILLER = ("The grass is green. The sky is blue. The sun is yellow. "
           "Here we go. There and back again. ")


def _rand_word(rng: random.Random, n: int = 6) -> str:
    return "".join(rng.choice(string.ascii_lowercase) for _ in range(n))


def _fill_to_words(rng: random.Random, n_words: int) -> List[str]:
    base = _FILLER.split()
    out: List[str] = []
    while len(out) < n_words:
        out.extend(base)
    return out[:n_words]


def generate_niah(num_samples: int = 16, context_words: int = 2000,
                  num_needles: int = 1, num_queries: int = 1,
                  seed: int = 42) -> Iterator[Dict]:
    """Needle-in-a-haystack: hide `num_needles` key->value pairs in filler,
    ask for `num_queries` of them."""
    rng = random.Random(seed)
    for idx in range(num_samples):
        words = _fill_to_words(rng, context_words)
        needles = [(f"{_rand_word(rng)}-{_rand_word(rng)}",
                    str(rng.randint(10000, 99999))) for _ in range(num_needles)]
        for key, val in needles:
            pos = rng.randint(0, len(words) - 1)
            words.insert(pos, f"One of the special magic numbers for {key} is: {val}.")
        queried = rng.sample(needles, min(num_queries, len(needles)))
        context = " ".join(words)
        keys = ", ".join(k for k, _ in queried)
        prompt = (f"Some special magic numbers are hidden within the following "
                  f"text. Make sure to memorize it. I will quiz you about the "
                  f"numbers afterwards.\n{context}\nWhat are all the special "
                  f"magic numbers for {keys} mentioned in the provided text?")
        yield {"index": idx, "input": prompt,
               "outputs": [v for _, v in queried],
               "length": len(prompt.split())}


def generate_variable_tracking(num_samples: int = 16, context_words: int = 2000,
                               num_chains: int = 1, num_hops: int = 4,
                               seed: int = 42) -> Iterator[Dict]:
    """Chained assignments: VAR A = 12345, VAR B = VAR A, ... query all
    variables equal to the value."""
    rng = random.Random(seed)
    for idx in range(num_samples):
        words = _fill_to_words(rng, context_words)
        answers: List[str] = []
        value = str(rng.randint(10000, 99999))
        for _ in range(num_chains):
            names = [_rand_word(rng, 5).upper() for _ in range(num_hops + 1)]
            stmts = [f"VAR {names[0]} = {value}."]
            stmts += [f"VAR {names[i + 1]} = VAR {names[i]}."
                      for i in range(num_hops)]
            for s in stmts:
                words.insert(rng.randint(0, len(words) - 1), s)
            answers.extend(names)
        context = " ".join(words)
        prompt = (f"Memorize and track the chain(s) of variable assignment "
                  f"hidden in the following text.\n{context}\nQuestion: Find "
                  f"all variables that are assigned the value {value} in the "
                  f"text above.")
        yield {"index": idx, "input": prompt, "outputs": answers,
               "length": len(prompt.split())}


def generate_common_words_extraction(num_samples: int = 16, num_lists: int = 10,
                                     words_per_list: int = 20,
                                     num_common: int = 5,
                                     seed: int = 42) -> Iterator[Dict]:
    rng = random.Random(seed)
    for idx in range(num_samples):
        common = [_rand_word(rng, 7) for _ in range(num_common)]
        lists = []
        for _ in range(num_lists):
            fillers = [_rand_word(rng, 7)
                       for _ in range(words_per_list - num_common)]
            row = common + fillers
            rng.shuffle(row)
            lists.append(row)
        body = "\n".join(f"List {i + 1}: {', '.join(row)}"
                         for i, row in enumerate(lists))
        prompt = (f"Below are {num_lists} word lists. Some words appear in "
                  f"every list.\n{body}\nQuestion: What are the words that "
                  f"appear in all of the lists?")
        yield {"index": idx, "input": prompt, "outputs": common,
               "length": len(prompt.split())}


def generate_freq_words_extraction(num_samples: int = 16, vocab: int = 30,
                                   stream_len: int = 400, top_k: int = 3,
                                   seed: int = 42) -> Iterator[Dict]:
    rng = random.Random(seed)
    for idx in range(num_samples):
        words = [_rand_word(rng, 6) for _ in range(vocab)]
        top = rng.sample(words, top_k)
        stream: List[str] = []
        for _ in range(stream_len):
            if rng.random() < 0.5:
                stream.append(rng.choice(top))
            else:
                stream.append(rng.choice(words))
        # guarantee the top words dominate
        stream.extend(top * (stream_len // (4 * top_k)))
        rng.shuffle(stream)
        prompt = (f"Read the following coded text and track the frequency of "
                  f"each coded word.\n{' '.join(stream)}\nQuestion: What are "
                  f"the {top_k} most frequently appeared words?")
        from collections import Counter

        counts = Counter(stream)
        answers = [w for w, _ in counts.most_common(top_k)]
        yield {"index": idx, "input": prompt, "outputs": answers,
               "length": len(prompt.split())}


def generate_qa(num_samples: int = 16, context_words: int = 2000,
                doc_words: int = 80, seed: int = 42) -> Iterator[Dict]:
    """Document QA: a gold passage among shuffled distractor documents, the
    answer extractable from the gold one; entity-fact documents synthesised
    locally (no download) with RULER's retrieval structure and row shape."""
    rng = random.Random(seed)
    num_docs = max(2, context_words // max(doc_words, 1))
    attrs = ["capital", "population", "founder", "currency", "anthem",
             "airport code", "motto", "area code"]
    for idx in range(num_samples):
        docs = []
        facts = []
        for d in range(num_docs):
            entity = _rand_word(rng, 8).capitalize()
            attr = rng.choice(attrs)
            value = _rand_word(rng, 7)
            filler = " ".join(_fill_to_words(rng, doc_words))
            docs.append(f"Document [{d + 1}] (about {entity}): {filler} "
                        f"The {attr} of {entity} is {value}. {filler}")
            facts.append((entity, attr, value))
        gold = rng.randrange(num_docs)
        rng.shuffle(docs)
        entity, attr, value = facts[gold]
        context = "\n\n".join(docs)
        prompt = (f"Answer the question based on the given documents. Only "
                  f"give me the answer and do not output any other words.\n\n"
                  f"The following are given documents.\n\n{context}\n\n"
                  f"Question: What is the {attr} of {entity}? Answer:")
        yield {"index": idx, "input": prompt, "outputs": [value],
               "length": len(prompt.split())}


TASKS = {
    "niah_single": lambda **kw: generate_niah(num_needles=1, **kw),
    "niah_multikey": lambda **kw: generate_niah(num_needles=4, num_queries=2, **kw),
    "variable_tracking": generate_variable_tracking,
    "common_words_extraction": generate_common_words_extraction,
    "freq_words_extraction": generate_freq_words_extraction,
    "qa": generate_qa,
}


def write_jsonl(task: str, path: str, **kw) -> int:
    """Write ``task``'s rows to ``path`` as JSON lines; returns the count."""
    gen = TASKS[task](**kw)
    n = 0
    with open(path, "w") as f:
        for row in gen:
            f.write(json.dumps(row) + "\n")
            n += 1
    return n


def score_row(row: Dict, prediction: str) -> float:
    """RULER match-any scoring: fraction of expected outputs present."""
    outs = row["outputs"]
    hits = sum(1 for o in outs if o.lower() in prediction.lower())
    return hits / max(len(outs), 1)
