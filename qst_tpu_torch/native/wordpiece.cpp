// Native batch WordPiece tokenizer.
//
// TPU-native counterpart of the wheel-level fast tokenizers the reference
// consumes implicitly in every sentence-transformers encode (SURVEY.md §2.3
// "Tokenization (HF fast tokenizers, sentencepiece)"): host-side tokenization
// is the input hot path feeding fixed-shape batches to the device, so it is
// implemented in C++ (greedy longest-match-first WordPiece over a hash-map
// vocab, multithreaded across the batch) and bound via ctypes — no
// Python-object traffic inside the loop.
//
// Semantics match qst_tpu.models.tokenizer.WordPieceTokenizer for ASCII
// input (lowercase, whitespace/punct split, "##" continuations, [CLS]/[SEP]
// framing, truncate-keep-final-SEP); the Python wrapper routes non-ASCII
// strings to the Python implementation so outputs are identical everywhere.

#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  int32_t cls_id, sep_id, unk_id, pad_id;
  int32_t max_chars_per_word;
  bool lowercase;
};

inline bool is_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// Greedy longest-match-first WordPiece of one word into `out`.
void wordpiece(const Tokenizer& t, const std::string& word,
               std::vector<int32_t>* out) {
  if ((int32_t)word.size() > t.max_chars_per_word) {
    out->push_back(t.unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int32_t> pieces;
  std::string sub;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t match = -1;
    while (start < end) {
      sub.clear();
      if (start > 0) sub = "##";
      sub.append(word, start, end - start);
      auto it = t.vocab.find(sub);
      if (it != t.vocab.end()) {
        match = it->second;
        break;
      }
      --end;
    }
    if (match < 0) {
      out->push_back(t.unk_id);
      return;
    }
    pieces.push_back(match);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

// Tokenize one text into ids (no framing).
void encode_text(const Tokenizer& t, const char* data, int64_t len,
                 std::vector<int32_t>* ids) {
  std::string word;
  auto flush = [&]() {
    if (!word.empty()) {
      wordpiece(t, word, ids);
      word.clear();
    }
  };
  for (int64_t i = 0; i < len; ++i) {
    unsigned char c = (unsigned char)data[i];
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
        c == '\v') {
      flush();
    } else if (is_punct(c)) {
      flush();
      word.push_back((char)c);
      flush();
    } else {
      word.push_back(t.lowercase ? (char)std::tolower(c) : (char)c);
    }
  }
  flush();
}

void encode_range(const Tokenizer* t, const char* buf, const int64_t* offsets,
                  int32_t max_length, int32_t* out_ids, int32_t* out_mask,
                  int begin, int end) {
  std::vector<int32_t> ids;
  for (int i = begin; i < end; ++i) {
    ids.clear();
    ids.push_back(t->cls_id);
    encode_text(*t, buf + offsets[i], offsets[i + 1] - offsets[i], &ids);
    ids.push_back(t->sep_id);
    if ((int32_t)ids.size() > max_length) {  // truncate, keep trailing [SEP]
      ids.resize(max_length);
      ids[max_length - 1] = t->sep_id;
    }
    int32_t* row_ids = out_ids + (int64_t)i * max_length;
    int32_t* row_mask = out_mask + (int64_t)i * max_length;
    int32_t n = (int32_t)ids.size();
    for (int32_t j = 0; j < n; ++j) {
      row_ids[j] = ids[j];
      row_mask[j] = 1;
    }
    for (int32_t j = n; j < max_length; ++j) {
      row_ids[j] = t->pad_id;
      row_mask[j] = 0;
    }
  }
}

}  // namespace

extern "C" {

// vocab arrives as one buffer of n null-terminated tokens; token index = id.
void* wp_create(const char* vocab_buf, int32_t n_tokens, int32_t cls_id,
                int32_t sep_id, int32_t unk_id, int32_t pad_id,
                int32_t lowercase, int32_t max_chars_per_word) {
  auto* t = new Tokenizer();
  const char* p = vocab_buf;
  t->vocab.reserve((size_t)n_tokens * 2);
  for (int32_t i = 0; i < n_tokens; ++i) {
    size_t len = std::strlen(p);
    t->vocab.emplace(std::string(p, len), i);
    p += len + 1;
  }
  t->cls_id = cls_id;
  t->sep_id = sep_id;
  t->unk_id = unk_id;
  t->pad_id = pad_id;
  t->lowercase = lowercase != 0;
  t->max_chars_per_word = max_chars_per_word;
  return t;
}

void wp_destroy(void* handle) { delete (Tokenizer*)handle; }

// texts as one concatenated byte buffer with n+1 offsets.
void wp_batch_encode(void* handle, const char* buf, const int64_t* offsets,
                     int32_t n_texts, int32_t max_length, int32_t n_threads,
                     int32_t* out_ids, int32_t* out_mask) {
  const Tokenizer* t = (const Tokenizer*)handle;
  if (n_threads <= 1 || n_texts < 64) {
    encode_range(t, buf, offsets, max_length, out_ids, out_mask, 0, n_texts);
    return;
  }
  int per = (n_texts + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int w = 0; w < n_threads; ++w) {
    int begin = w * per;
    int end = begin + per < n_texts ? begin + per : n_texts;
    if (begin >= end) break;
    threads.emplace_back(encode_range, t, buf, offsets, max_length, out_ids,
                         out_mask, begin, end);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
