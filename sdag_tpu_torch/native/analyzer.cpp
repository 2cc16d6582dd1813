// Lucene-EnglishAnalyzer-fidelity text analysis:
//   StandardTokenizer (UAX#29 word segmentation, practical subset)
//   -> EnglishPossessiveFilter ('s / ’s / ＇s stripped)
//   -> LowerCaseFilter (Unicode 1:1 mappings, unicode_tables.h)
//   -> StopFilter (Lucene ENGLISH_STOP_WORDS_SET, 33 words)
//   -> PorterStemFilter (classic 1980 algorithm over codepoints; non-ASCII
//      letters are consonants, exactly like Lucene's char-based stemmer)
//
// TPU-native replacement for the host-side half of the reference's
// Pyserini/Lucene BM25 path (src/pipeline/retrieval/sparse.py:11-64): the
// JVM analyzer chain becomes this C library (driven via ctypes); scoring
// runs on device (sdag_tpu/ops/bm25.py).
//
// UAX#29 subset implemented (covers Wikipedia-scale corpora):
//   - words = runs of Unicode letters/digits (category L*, Nl / Nd)
//   - WB4: Extend (Mn/Mc/Me) and Format (Cf minus U+200B) are transparent
//     and ride inside the token (combining accents, ZWJ/ZWNJ, Devanagari
//     matras, kana voicing marks); join rules look through them
//   - medial joins with lookahead over transparents: apostrophe between
//     letters ("don't", "o'brien"), '.'/U+FF0E between letters or between
//     digits ("example.com", "3.14"), ',' between digits ("1,000")
//   - '_' (ExtendNumLet, WB13a/b) joins word and Katakana tokens
//   - Han and Hiragana ideograms tokenize one per codepoint; Katakana in
//     runs (WB13)
//   - tokens cap at 255 codepoints (StandardTokenizer maxTokenLength)
// Known deviations are mirrored bit-for-bit by the Python fallback
// (retrieval/analyzer.py) and covered by tests/fixtures golden cases.
//
// Batch protocol: documents separated by '\x02' on input; output tokens
// separated by '\x01' within a doc, docs separated by '\x02'.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#include "unicode_tables.h"

namespace {

const std::unordered_set<std::string>& stopwords() {
  // Lucene EnglishAnalyzer ENGLISH_STOP_WORDS_SET
  static const std::unordered_set<std::string> kStop = {
      "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if",
      "in", "into", "is", "it", "no", "not", "of", "on", "or", "such",
      "that", "the", "their", "then", "there", "these", "they", "this",
      "to", "was", "will", "with"};
  return kStop;
}

bool in_ranges(uint32_t cp, const U32Range* r, int n) {
  int lo = 0, hi = n - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (cp < r[mid].lo) hi = mid - 1;
    else if (cp > r[mid].hi) lo = mid + 1;
    else return true;
  }
  return false;
}

uint32_t to_lower(uint32_t cp) {
  if (cp < 128) return (cp >= 'A' && cp <= 'Z') ? cp + 32 : cp;
  int lo = 0, hi = kLowerPairsCount - 1;
  while (lo <= hi) {
    int mid = (lo + hi) / 2;
    if (cp < kLowerPairs[mid].from) hi = mid - 1;
    else if (cp > kLowerPairs[mid].from) lo = mid + 1;
    else return kLowerPairs[mid].to;
  }
  return cp;
}

enum Cls : uint8_t {
  OTHER = 0, LETTER, DIGIT, HAN, HIRA, KATA, APOS, DOT, COMMA, UNDER,
  EXTEND
};

Cls classify(uint32_t cp) {
  if (cp < 128) {  // fast ASCII path
    if ((cp >= 'a' && cp <= 'z') || (cp >= 'A' && cp <= 'Z')) return LETTER;
    if (cp >= '0' && cp <= '9') return DIGIT;
    switch (cp) {
      case '_': return UNDER;
      case '\'': return APOS;
      case '.': return DOT;
      case ',': return COMMA;
      default: return OTHER;
    }
  }
  if (cp == 0x2019 || cp == 0xFF07) return APOS;  // ' fullwidth '
  if (cp == 0xFF0E) return DOT;                   // fullwidth .
  // UAX#29 WB4 transparent chars (Extend: Mn/Mc/Me; Format: Cf minus
  // U+200B) BEFORE the script ranges: U+3099/309A sit inside the
  // Hiragana block but are Mn combining marks
  if (in_ranges(cp, kExtendRanges, kExtendRangesCount)) return EXTEND;
  // CJK before the general letter table (Han/Kana are category Lo)
  if ((cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
      (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x20000 && cp <= 0x2FA1F))
    return HAN;
  if (cp >= 0x3041 && cp <= 0x309F) return HIRA;
  if ((cp >= 0x30A0 && cp <= 0x30FF) || (cp >= 0x31F0 && cp <= 0x31FF) ||
      (cp >= 0xFF66 && cp <= 0xFF9D))
    return KATA;
  if (in_ranges(cp, kDigitRanges, kDigitRangesCount)) return DIGIT;
  if (in_ranges(cp, kLetterRanges, kLetterRangesCount)) return LETTER;
  return OTHER;
}

// ---------------------------------------------------------------------------
// UTF-8 <-> codepoints
// ---------------------------------------------------------------------------
void decode_utf8(const char* p, const char* end, std::vector<uint32_t>* out) {
  while (p < end) {
    unsigned char c = static_cast<unsigned char>(*p);
    uint32_t cp;
    int len;
    if (c < 0x80) { cp = c; len = 1; }
    else if ((c >> 5) == 0x6) { cp = c & 0x1F; len = 2; }
    else if ((c >> 4) == 0xE) { cp = c & 0x0F; len = 3; }
    else if ((c >> 3) == 0x1E) { cp = c & 0x07; len = 4; }
    else { ++p; continue; }  // stray continuation byte: skip
    if (p + len > end) break;
    bool ok = true;
    for (int i = 1; i < len; ++i) {
      unsigned char cc = static_cast<unsigned char>(p[i]);
      if ((cc >> 6) != 0x2) { ok = false; break; }
      cp = (cp << 6) | (cc & 0x3F);
    }
    if (!ok) { ++p; continue; }
    out->push_back(cp);
    p += len;
  }
}

void encode_utf8(uint32_t cp, std::string* out) {
  if (cp < 0x80) {
    out->push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out->push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out->push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out->push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// ---------------------------------------------------------------------------
// Porter stemmer (classic 1980 algorithm) over codepoints.  Non-ASCII
// letters fall through the vowel switch as consonants, matching Lucene's
// char-based PorterStemmer.
// ---------------------------------------------------------------------------
typedef std::vector<uint32_t> U32;

class PorterStemmer {
 public:
  U32 stem(const U32& in) {
    if (in.size() <= 2) return in;
    b_ = in;
    k_ = static_cast<int>(b_.size()) - 1;
    step1ab();
    step1c();
    step2();
    step3();
    step4();
    step5();
    return U32(b_.begin(), b_.begin() + k_ + 1);
  }

 private:
  U32 b_;
  int k_ = 0;
  int j_ = 0;

  bool cons(int i) const {
    switch (b_[i]) {
      case 'a': case 'e': case 'i': case 'o': case 'u':
        return false;
      case 'y':
        return (i == 0) ? true : !cons(i - 1);
      default:
        return true;
    }
  }

  int m() const {  // consonant-vowel sequence measure over [0, j_]
    int n = 0, i = 0;
    while (true) {
      if (i > j_) return n;
      if (!cons(i)) break;
      i++;
    }
    i++;
    while (true) {
      while (true) {
        if (i > j_) return n;
        if (cons(i)) break;
        i++;
      }
      i++;
      n++;
      while (true) {
        if (i > j_) return n;
        if (!cons(i)) break;
        i++;
      }
      i++;
    }
  }

  bool vowelinstem() const {
    for (int i = 0; i <= j_; i++)
      if (!cons(i)) return true;
    return false;
  }

  bool doublec(int j) const {
    if (j < 1) return false;
    if (b_[j] != b_[j - 1]) return false;
    return cons(j);
  }

  bool cvc(int i) const {
    if (i < 2 || !cons(i) || cons(i - 1) || !cons(i - 2)) return false;
    uint32_t ch = b_[i];
    return ch != 'w' && ch != 'x' && ch != 'y';
  }

  bool ends(const char* s) {
    int l = static_cast<int>(std::strlen(s));
    if (l > k_ + 1) return false;
    for (int i = 0; i < l; ++i)
      if (b_[k_ - l + 1 + i] != static_cast<uint32_t>(s[i])) return false;
    j_ = k_ - l;
    return true;
  }

  void setto(const char* s) {
    int l = static_cast<int>(std::strlen(s));
    b_.resize(j_ + 1 + l);
    for (int i = 0; i < l; ++i) b_[j_ + 1 + i] = static_cast<uint32_t>(s[i]);
    k_ = j_ + l;
  }

  void r(const char* s) {
    if (m() > 0) setto(s);
  }

  void step1ab() {
    if (b_[k_] == 's') {
      if (ends("sses")) k_ -= 2;
      else if (ends("ies")) setto("i");
      else if (b_[k_ - 1] != 's') k_--;
    }
    if (ends("eed")) {
      if (m() > 0) k_--;
    } else if ((ends("ed") || ends("ing")) && vowelinstem()) {
      k_ = j_;
      if (ends("at")) setto("ate");
      else if (ends("bl")) setto("ble");
      else if (ends("iz")) setto("ize");
      else if (doublec(k_)) {
        k_--;
        uint32_t ch = b_[k_];
        if (ch == 'l' || ch == 's' || ch == 'z') k_++;
      } else if (m() == 1 && cvc(k_)) {
        setto("e");
      }
    }
  }

  void step1c() {
    if (ends("y") && vowelinstem()) b_[k_] = 'i';
  }

  void step2() {
    if (k_ < 1) return;
    switch (b_[k_ - 1]) {
      case 'a':
        if (ends("ational")) { r("ate"); break; }
        if (ends("tional")) { r("tion"); break; }
        break;
      case 'c':
        if (ends("enci")) { r("ence"); break; }
        if (ends("anci")) { r("ance"); break; }
        break;
      case 'e':
        if (ends("izer")) { r("ize"); break; }
        break;
      case 'l':
        if (ends("bli")) { r("ble"); break; }
        if (ends("alli")) { r("al"); break; }
        if (ends("entli")) { r("ent"); break; }
        if (ends("eli")) { r("e"); break; }
        if (ends("ousli")) { r("ous"); break; }
        break;
      case 'o':
        if (ends("ization")) { r("ize"); break; }
        if (ends("ation")) { r("ate"); break; }
        if (ends("ator")) { r("ate"); break; }
        break;
      case 's':
        if (ends("alism")) { r("al"); break; }
        if (ends("iveness")) { r("ive"); break; }
        if (ends("fulness")) { r("ful"); break; }
        if (ends("ousness")) { r("ous"); break; }
        break;
      case 't':
        if (ends("aliti")) { r("al"); break; }
        if (ends("iviti")) { r("ive"); break; }
        if (ends("biliti")) { r("ble"); break; }
        break;
      case 'g':
        if (ends("logi")) { r("log"); break; }
        break;
    }
  }

  void step3() {
    switch (b_[k_]) {
      case 'e':
        if (ends("icate")) { r("ic"); break; }
        if (ends("ative")) { r(""); break; }
        if (ends("alize")) { r("al"); break; }
        break;
      case 'i':
        if (ends("iciti")) { r("ic"); break; }
        break;
      case 'l':
        if (ends("ical")) { r("ic"); break; }
        if (ends("ful")) { r(""); break; }
        break;
      case 's':
        if (ends("ness")) { r(""); break; }
        break;
    }
  }

  void step4() {
    if (k_ < 1) return;
    switch (b_[k_ - 1]) {
      case 'a': if (ends("al")) break; return;
      case 'c': if (ends("ance")) break; if (ends("ence")) break; return;
      case 'e': if (ends("er")) break; return;
      case 'i': if (ends("ic")) break; return;
      case 'l': if (ends("able")) break; if (ends("ible")) break; return;
      case 'n':
        if (ends("ant")) break;
        if (ends("ement")) break;
        if (ends("ment")) break;
        if (ends("ent")) break;
        return;
      case 'o':
        if (ends("ion") && j_ >= 0 && (b_[j_] == 's' || b_[j_] == 't')) break;
        if (ends("ou")) break;
        return;
      case 's': if (ends("ism")) break; return;
      case 't': if (ends("ate")) break; if (ends("iti")) break; return;
      case 'u': if (ends("ous")) break; return;
      case 'v': if (ends("ive")) break; return;
      case 'z': if (ends("ize")) break; return;
      default: return;
    }
    if (m() > 1) k_ = j_;
  }

  void step5() {
    j_ = k_;
    if (b_[k_] == 'e') {
      int a = m();
      if (a > 1 || (a == 1 && !cvc(k_ - 1))) k_--;
    }
    if (b_[k_] == 'l' && doublec(k_) && m() > 1) k_--;
  }
};

// ---------------------------------------------------------------------------
// Tokenizer + filter chain
// ---------------------------------------------------------------------------
constexpr int kMaxTokenLen = 255;  // StandardTokenizer maxTokenLength

void analyze_doc(const char* begin, const char* end, std::string* out) {
  std::vector<uint32_t> cps;
  cps.reserve(static_cast<size_t>(end - begin));
  decode_utf8(begin, end, &cps);
  std::vector<Cls> cls(cps.size());
  for (size_t i = 0; i < cps.size(); ++i) cls[i] = classify(cps[i]);

  PorterStemmer stemmer;
  U32 cur;
  bool cur_has_alnum = false;
  bool first = true;
  // class of the token's last non-Extend codepoint: WB4 transparency —
  // combining marks / format chars inside a token never perturb the
  // WB5-WB13 join rules around them
  Cls last_base = OTHER;

  auto flush = [&]() {
    if (!cur.empty() && cur_has_alnum) {
      // EnglishPossessiveFilter: strip trailing 's / 'S (all apostrophes)
      size_t n = cur.size();
      if (n >= 2 && (cur[n - 1] == 's' || cur[n - 1] == 'S') &&
          (cur[n - 2] == 0x27 || cur[n - 2] == 0x2019 ||
           cur[n - 2] == 0xFF07)) {
        cur.resize(n - 2);
      }
      for (auto& cp : cur) cp = to_lower(cp);
      std::string utf8;
      for (uint32_t cp : cur) encode_utf8(cp, &utf8);
      if (!utf8.empty() && stopwords().count(utf8) == 0) {
        U32 stemmed = stemmer.stem(cur);
        std::string sout;
        for (uint32_t cp : stemmed) encode_utf8(cp, &sout);
        if (!sout.empty()) {
          if (!first) out->push_back('\x01');
          out->append(sout);
          first = false;
        }
      }
    }
    cur.clear();
    cur_has_alnum = false;
    last_base = OTHER;
  };

  const size_t n = cps.size();
  // class of the next non-Extend codepoint after i (WB4 skip)
  auto next_base = [&](size_t i) -> Cls {
    for (size_t j = i + 1; j < n; ++j)
      if (cls[j] != EXTEND) return cls[j];
    return OTHER;
  };

  for (size_t i = 0; i < n; ++i) {
    const Cls c = cls[i];
    // force-split at maxTokenLength for ANY continuation — including
    // Extend/Format (WB4) chars, which would otherwise grow the open
    // token without bound (Lucene splits at 255 unconditionally)
    if (static_cast<int>(cur.size()) >= kMaxTokenLen) flush();
    switch (c) {
      case EXTEND:  // WB4: attach to the open token, never break
        if (!cur.empty()) cur.push_back(cps[i]);
        break;
      case HAN:
      case HIRA:
        // one token per ideograph (kept open so trailing Extend marks
        // attach); nothing joins across it
        flush();
        cur.push_back(cps[i]);
        cur_has_alnum = true;
        last_base = c;
        break;
      case KATA:
        if (last_base != KATA && last_base != UNDER) flush();  // WB13/13b
        cur.push_back(cps[i]);
        cur_has_alnum = true;
        last_base = KATA;
        break;
      case LETTER:
      case DIGIT:
        if (last_base == HAN || last_base == HIRA || last_base == KATA)
          flush();
        cur.push_back(cps[i]);
        cur_has_alnum = true;
        last_base = c;
        break;
      case UNDER:  // ExtendNumLet (WB13a/b): joins words/katakana
        if (last_base == HAN || last_base == HIRA) flush();
        cur.push_back(cps[i]);
        last_base = UNDER;
        break;
      case APOS:  // MidLetter (WB6/7): letter ' letter
        if (last_base == LETTER && next_base(i) == LETTER) {
          cur.push_back(cps[i]);
        } else {
          flush();
        }
        break;
      case DOT: {  // MidNumLet: letter.letter / MidNum: digit.digit
        const Cls nb = next_base(i);
        if ((last_base == LETTER && nb == LETTER) ||
            (last_base == DIGIT && nb == DIGIT)) {
          cur.push_back(cps[i]);
        } else {
          flush();
        }
        break;
      }
      case COMMA:  // MidNum (WB11/12): digit,digit
        if (last_base == DIGIT && next_base(i) == DIGIT) {
          cur.push_back(cps[i]);
        } else {
          flush();
        }
        break;
      default:
        flush();
        break;
    }
  }
  flush();
}

}  // namespace

extern "C" {

// Analyze a batch of '\x02'-separated docs.  Returns a malloc'd buffer the
// caller frees with analyzer_free; *out_len receives its length.
char* analyze_batch(const char* input, int64_t input_len, int64_t* out_len) {
  std::string out;
  out.reserve(static_cast<size_t>(input_len));
  const char* p = input;
  const char* end = input + input_len;
  bool first_doc = true;
  while (p <= end) {
    const char* sep = static_cast<const char*>(
        memchr(p, '\x02', static_cast<size_t>(end - p)));
    const char* doc_end = sep ? sep : end;
    if (!first_doc) out.push_back('\x02');
    analyze_doc(p, doc_end, &out);
    first_doc = false;
    if (!sep) break;
    p = sep + 1;
  }
  char* buf = static_cast<char*>(malloc(out.size()));
  memcpy(buf, out.data(), out.size());
  *out_len = static_cast<int64_t>(out.size());
  return buf;
}

void analyzer_free(char* p) { free(p); }

// BM25 index-build counting: analyze a batch of '\x02'-separated docs and
// return vocab + per-doc (term id, tf) pairs + df + doc lengths in one
// binary buffer — the whole tokenize+count phase stays native (Lucene's
// indexing is JVM-native; reference src/pipeline/retrieval/sparse.py
// delegates it to Pyserini).  Layout (little-endian, 8-byte header part):
//   int64 n_docs, n_vocab, n_pairs, vocab_blob_len
//   int64 doc_offsets[n_docs + 1]      (pair ranges per doc)
//   int32 doc_len[n_docs]              (analyzed token count incl. dups)
//   int32 df[n_vocab]
//   int32 pair_tid[n_pairs]
//   int32 pair_tf[n_pairs]
//   char  vocab_blob[vocab_blob_len]   ('\x01'-joined, first-appearance order)
char* bm25_build_counts(const char* input, int64_t input_len,
                        int64_t* out_len) {
  std::unordered_map<std::string, int32_t> vocab;
  std::vector<std::string> terms;          // id -> term
  std::vector<int32_t> df;
  std::vector<int32_t> last_doc;           // df dedup per doc
  std::vector<int64_t> doc_offsets(1, 0);
  std::vector<int32_t> doc_len;
  std::vector<int32_t> pair_tid, pair_tf;

  const char* p = input;
  const char* end = input + input_len;
  int32_t doc = 0;
  std::unordered_map<int32_t, int32_t> counts;
  while (p <= end) {
    const char* sep = static_cast<const char*>(
        memchr(p, '\x02', static_cast<size_t>(end - p)));
    const char* doc_end = sep ? sep : end;

    std::string toks;
    analyze_doc(p, doc_end, &toks);
    counts.clear();
    int32_t n_toks = 0;
    size_t s = 0;
    while (s <= toks.size()) {
      size_t e = toks.find('\x01', s);
      if (e == std::string::npos) e = toks.size();
      if (e > s) {
        std::string term = toks.substr(s, e - s);
        auto it = vocab.find(term);
        int32_t tid;
        if (it == vocab.end()) {
          tid = static_cast<int32_t>(terms.size());
          vocab.emplace(term, tid);
          terms.push_back(std::move(term));
          df.push_back(0);
          last_doc.push_back(-1);
        } else {
          tid = it->second;
        }
        ++counts[tid];
        ++n_toks;
      }
      if (e == toks.size()) break;
      s = e + 1;
    }
    // pairs in ascending tid order (deterministic across runs)
    std::vector<int32_t> tids;
    tids.reserve(counts.size());
    for (const auto& kv : counts) tids.push_back(kv.first);
    std::sort(tids.begin(), tids.end());
    for (int32_t tid : tids) {
      pair_tid.push_back(tid);
      pair_tf.push_back(counts[tid]);
      if (last_doc[static_cast<size_t>(tid)] != doc) {
        last_doc[static_cast<size_t>(tid)] = doc;
        ++df[static_cast<size_t>(tid)];
      }
    }
    doc_offsets.push_back(static_cast<int64_t>(pair_tid.size()));
    doc_len.push_back(n_toks);
    ++doc;
    if (!sep) break;
    p = sep + 1;
  }

  std::string blob;
  for (size_t i = 0; i < terms.size(); ++i) {
    if (i) blob.push_back('\x01');
    blob.append(terms[i]);
  }
  const int64_t n_docs = doc;
  const int64_t n_vocab = static_cast<int64_t>(terms.size());
  const int64_t n_pairs = static_cast<int64_t>(pair_tid.size());
  const int64_t blob_len = static_cast<int64_t>(blob.size());
  const size_t bytes = sizeof(int64_t) * 4
      + sizeof(int64_t) * doc_offsets.size()
      + sizeof(int32_t) * (doc_len.size() + df.size())
      + sizeof(int32_t) * (pair_tid.size() + pair_tf.size())
      + blob.size();
  char* buf = static_cast<char*>(malloc(bytes));
  char* w = buf;
  auto put = [&w](const void* src, size_t n) {
    memcpy(w, src, n);
    w += n;
  };
  int64_t hdr[4] = {n_docs, n_vocab, n_pairs, blob_len};
  put(hdr, sizeof(hdr));
  put(doc_offsets.data(), sizeof(int64_t) * doc_offsets.size());
  put(doc_len.data(), sizeof(int32_t) * doc_len.size());
  put(df.data(), sizeof(int32_t) * df.size());
  put(pair_tid.data(), sizeof(int32_t) * pair_tid.size());
  put(pair_tf.data(), sizeof(int32_t) * pair_tf.size());
  put(blob.data(), blob.size());
  *out_len = static_cast<int64_t>(bytes);
  return buf;
}

}  // extern "C"
